from .gpt import (GPTBlock, GPTConfig, GPTForPretraining,  # noqa: F401
                  GPTModel, GPTPretrainingCriterion,
                  gpt2_large_config, gpt2_medium_config,
                  gpt2_small_config)
