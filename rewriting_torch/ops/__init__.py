from .fused_act import fused_leaky_relu
from .upfirdn2d import make_kernel, upfirdn2d, upsample2d

# ``blur2d`` the function lives in ops.upfirdn2d; ``ops.blur2d`` is the
# module of its CUDA kernel and plain version
__all__ = ["fused_leaky_relu", "upfirdn2d", "make_kernel", "upsample2d"]
