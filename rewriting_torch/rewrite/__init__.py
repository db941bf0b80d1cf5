from .rewriter import GanRewriter, SeqStyleGanRewriter
from .solve import insert_solve, projected_conv, zca_from_cov

__all__ = ["GanRewriter", "SeqStyleGanRewriter", "insert_solve",
           "projected_conv", "zca_from_cov"]
