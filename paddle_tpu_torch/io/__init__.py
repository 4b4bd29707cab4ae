"""paddle_tpu_torch.io (counterpart of paddle_tpu/io/): the filesystem
clients.  The DataLoader, the datasets and samplers of ``io`` are ROADMAP
item 9c."""
from .fs import (FS, ExecuteError, FSFileExistsError,  # noqa: F401
                 FSFileNotExistsError, FSTimeOut, HDFSClient, LocalFS, get_fs)
