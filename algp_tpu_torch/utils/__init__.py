from algp_tpu_torch.utils import checkpoint as checkpoint  # noqa: F401
from algp_tpu_torch.utils import metrics as metrics  # noqa: F401
