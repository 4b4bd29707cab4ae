from .bert import (BertConfig, BertForPretraining,  # noqa: F401
                   BertForSequenceClassification, BertModel,
                   BertPretrainingCriterion, bert_base_config,
                   bert_large_config)
from .dlrm import (DLRM, DLRMConfig, DLRMCriterion,  # noqa: F401
                   dlrm_tiny_config)
from .ernie import (ErnieConfig, ErnieForPretraining,  # noqa: F401
                    ErnieForSequenceClassification, ErnieModel,
                    ErniePretrainingCriterion, ernie_base_config,
                    ernie_large_config)
from .gpt import (GPTBlock, GPTConfig, GPTForPretraining,  # noqa: F401
                  GPTModel, GPTPretrainingCriterion,
                  gpt2_large_config, gpt2_medium_config,
                  gpt2_small_config)
