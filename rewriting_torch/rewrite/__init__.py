from .rewriter import (GanRewriter, ProgressiveGanRewriter,
                       SeqPreStyleGanRewriter, SeqStyleGanRewriter,
                       SeqTinyStyleGanRewriter)
from .solve import (fast_linear_insert_solve, insert_solve,
                    linear_insert_solve, projected_conv, zca_from_cov)

__all__ = ["GanRewriter", "ProgressiveGanRewriter", "SeqStyleGanRewriter",
           "SeqTinyStyleGanRewriter", "SeqPreStyleGanRewriter",
           "insert_solve", "linear_insert_solve", "fast_linear_insert_solve",
           "projected_conv", "zca_from_cov"]
