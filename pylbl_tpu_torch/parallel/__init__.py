from .lines import (UnstackableError, as_tensors,  # noqa: F401
                    derive_envelope, device_line_pack, line_kernel_arrays,
                    make_batched_fn, make_batched_tpu_fn,
                    make_multigas_batched_fn,
                    make_stacked_pedestal_remover, stack_device_packs)
from .mesh import (BATCH_AXIS, SPEC_AXIS, batch_sharded,  # noqa: F401
                   grid_sharded, make_mesh, replicated)
from .shard_plans import shard_line_pack, shard_stacked_packs  # noqa: F401
from .sharded import (make_lines_sharded_step,  # noqa: F401
                      make_multigas_sharded_pipeline, make_sharded_pipeline,
                      make_sharded_step)
