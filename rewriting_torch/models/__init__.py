from .proggan import ProgressiveGenerator
from .stylegan2 import SeqStyleGAN2

__all__ = ["ProgressiveGenerator", "SeqStyleGAN2"]
