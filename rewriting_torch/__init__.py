"""rewriting_torch — the PyTorch/CUDA port of the rewriting framework.

The same functional design as the JAX package it is held against: a
generator is a :class:`~rewriting_torch.core.StagePipeline` of named stage
functions over a flat params dict and a :class:`~rewriting_torch.core.DataBag`
of tensors; surgery is slicing the pipeline; a weight edit is a rank-1
constrained solve on one conv's weight.  Inside the model, activations are
NCHW; the rewriter's public accessors keep the NHWC shapes of the JAX
package so the two can be compared directly.

Three hand-written CUDA kernels run on a CUDA tensor, each with its plain
PyTorch version for a CPU tensor: the FIR blur after every up-conv of the
seq pipeline, with its backward (``csrc/blur2d.cu``); the fused up-conv +
blur + epilogue of the sampling pipeline ``pipeline_fast``
(``csrc/upconv_blur.cu``); and the 2x FIR upsample of wide maps
(``csrc/upsample2x.cu``).  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; they raise if CUDA is asked for and absent.
"""

__version__ = "0.1.0"
