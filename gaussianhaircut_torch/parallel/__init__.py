"""The multi-device stage-1 step on ``torch.distributed`` (port of
``gaussianhaircut_tpu/parallel``): camera data parallelism and tile-row
sharding over a (data, tile) process mesh."""
from gaussianhaircut_torch.parallel.data_parallel import (  # noqa: F401
    dp_train_step,
)
from gaussianhaircut_torch.parallel.mesh import (  # noqa: F401
    make_camera_mesh,
    make_mesh2d,
)
from gaussianhaircut_torch.parallel.tile_parallel import (  # noqa: F401
    dp_tp_train_step,
)
