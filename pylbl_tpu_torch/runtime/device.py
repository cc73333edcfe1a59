"""Device selection for the port's compute entry points."""
import torch


def resolve_device(device):
    """Returns ``torch.device(device)``, raising when CUDA is asked for and
    absent (the port never falls back to the CPU on its own).  On CUDA it
    also turns TF32 off for float32 matrix products and convolutions, so
    no float32 path of the port rounds through TF32."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not "
                               "available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
