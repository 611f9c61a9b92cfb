from algp_tpu_torch.ops import chol as chol  # noqa: F401
from algp_tpu_torch.ops import gram as gram  # noqa: F401
from algp_tpu_torch.ops import kernels as kernels  # noqa: F401
from algp_tpu_torch.ops import linalg as linalg  # noqa: F401
from algp_tpu_torch.ops import updates as updates  # noqa: F401
