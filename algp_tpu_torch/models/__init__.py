from algp_tpu_torch.models import gp as gp  # noqa: F401
