"""The mesh paths over `torch.distributed` (the counterpart of
algp_tpu.parallel): restart-sharded fits, candidate-sharded greedy entropy
and Krause MI (replicated or distributed seed), the distributed Cholesky
and inverse, sharded low-rank MI, and the config-5 episode's sharded
seeds and plan step (`sharded_episode`, driven by `episode.Agent(mesh=)`).
`launch` starts a world of ranks; `dryrun` is the twin of the reference's
multi-chip dry run."""

from algp_tpu_torch.parallel import dist_linalg as dist_linalg  # noqa: F401
from algp_tpu_torch.parallel import sharded as sharded  # noqa: F401
from algp_tpu_torch.parallel import sharded_episode as sharded_episode  # noqa: F401
from algp_tpu_torch.parallel import sharded_lowrank as sharded_lowrank  # noqa: F401
from algp_tpu_torch.parallel import sharded_mi as sharded_mi  # noqa: F401
from algp_tpu_torch.parallel.sharded import (  # noqa: F401
    make_mesh,
    sharded_fit,
    sharded_fit_icm,
    sharded_training_step,
)
from algp_tpu_torch.parallel.sharded_lowrank import (  # noqa: F401
    sharded_greedy_select_mi_lowrank,
)
from algp_tpu_torch.parallel.sharded_mi import sharded_greedy_select_mi  # noqa: F401
