from .lines import (UnstackableError, as_tensors,  # noqa: F401
                    derive_envelope, device_line_pack, line_kernel_arrays,
                    make_multigas_batched_fn, make_stacked_pedestal_remover,
                    stack_device_packs)
