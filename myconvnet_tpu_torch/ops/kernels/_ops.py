"""The kernels of the served paths as torch custom ops (namespace ``mcn``).

B1 (``mcn::bn_act``), B4 (``mcn::conv_fused``), B5 (``mcn::conv_pair``),
B6's forward (``mcn::flash_attention_fwd``) and B9's forward
(``mcn::correlation_fwd``) are registered with ``torch.library.custom_op``
in their modules: the ``"cuda"`` implementation is the module's
``launch_cuda`` (the ctypes launch, with its checks and its ``.launches``
count), the ``"cpu"`` implementation is the module's plain version, and the
fake implementation gives the exact shapes, dtypes and strides of the CUDA
outputs.  ``torch.export`` traces with fake tensors, which have no data
pointer; through the op an exported program keeps each kernel as one graph
node, and running the program launches the kernel.  The registered CUDA
implementations look their module's launch function up when called, so a
caller that wraps it (``chip_smoke.launch_shapes``) sees every launch.

The public wrappers keep their names and signatures.  On a CUDA tensor
they call the launch function directly (:func:`direct`), outside the
dispatcher, whose host time a launch the eager paths would otherwise pay;
only while ``torch.export`` traces do they call the op, and a loaded
artifact calls it from its graph.  On a CPU tensor they call the op,
except where autograd records the call (grad mode on and an input that
requires grad): there they run the plain version outside the op, so its
graph reaches autograd.  The ops have no backward, and the CUDA kernels
never had one there either (the training paths differentiate through
``FlashAttention`` and ``_Correlation``).
"""

from __future__ import annotations

import collections

import torch

NAMESPACE = "mcn"


def direct(x: torch.Tensor) -> bool:
    """Whether a wrapper launches its kernel on ``x`` without the op: a
    CUDA tensor outside a ``torch.export`` trace."""
    return x.is_cuda and not torch.compiler.is_exporting()


def autograd_on_cpu(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on these (CPU) tensors."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def op_nodes(graph: torch.fx.Graph) -> collections.Counter:
    """{op name: nodes} of the ``mcn::`` ops in an exported graph."""
    out = collections.Counter()
    for node in graph.nodes:
        target = node.target
        if (node.op == "call_function"
                and getattr(target, "namespace", None) == NAMESPACE):
            out[target._schema.name.split("::", 1)[1]] += 1
    return out
