"""The benchmark of the PyTorch and CUDA port (`algp_tpu_torch`)."""
