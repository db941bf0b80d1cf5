from .stylegan2 import SeqStyleGAN2

__all__ = ["SeqStyleGAN2"]
