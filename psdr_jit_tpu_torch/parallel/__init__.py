from .mesh import ProcessMesh, make_device_mesh, render_sharded
from .shard import (make_fused_train_step, make_sharded_value_and_grad,
                    sync_guiding, train_step_example)

__all__ = [
    "ProcessMesh", "make_device_mesh", "render_sharded",
    "make_fused_train_step", "make_sharded_value_and_grad", "sync_guiding",
    "train_step_example",
]
