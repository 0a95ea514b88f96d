"""The TCN's bf16 inference forward channels-last, one fused kernel a
convolution (``csrc/tcn_conv.cu``).

``tcn_conv`` is one causal dilated convolution of a residual block with
its whole epilogue, on ``[N, T, C]`` activations:

- ``relu(conv(x) + bias)`` (a block's first convolution);
- with ``residual`` ``[N, T, C]``: ``relu(residual + relu(conv(x) +
  bias))``, the sum in float32, rounded once (a block's second);
- with ``shortcut=(signal [N, T], w_sc [C], b_sc [C])``: the same with
  the residual the 1×1 shortcut of a 1-channel signal, recomputed.

It rounds where ``models/tcn.py``'s ``ResidualBlock`` rounds: the product
to bf16, the bf16 bias added in float32 and rounded, and the residual sum
in float32.  Given CUDA tensors it launches the kernel (bf16 only, 256
output channels, ``C_in`` 1 or 256) or raises; given CPU tensors it runs
``tcn_conv_plain``, today's arithmetic (``causal_conv1d``) in any dtype.

``engages(model, x, train)`` is the rule ``SigToSeq.forward`` takes this
path by, with no knob: a CUDA input, a bf16 model, autograd off, every
convolution a plain ``CausalConv1D`` (not ``models/tensor_parallel.py``'s
``ColumnParallel``), 256 filters, a 1-channel input with block 0's
shortcut, no skip connections.  Everything else keeps ``TCN.forward``.
``tcn_forward`` runs the stack: 2 launches a block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from radian_tpu_torch import _build
from radian_tpu_torch.models.tcn import TCN, CausalConv1D, causal_conv1d
from radian_tpu_torch.utils import profiling

CHANNELS = 256  # the kernel's C_out, and its C_in after block 0
MAX_TAPS_IN = 8  # widest kernel of the 1-channel convolution


def tcn_conv_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   dilation: int, residual: torch.Tensor | None = None,
                   shortcut: tuple | None = None) -> torch.Tensor:
    """``tcn_conv``'s function in plain PyTorch, in ``x``'s dtype:
    ``ResidualBlock``'s arithmetic through ``causal_conv1d`` on the
    transposed layout, so it equals the unfused block bit for bit."""
    c_out, c_in = weight.shape[0], x.shape[2]
    w = weight.view(c_out, -1, c_in).transpose(1, 2).contiguous()
    y = F.relu(causal_conv1d(x.transpose(1, 2), w, bias, dilation))
    if shortcut is not None:
        signal, w_sc, b_sc = shortcut
        res = causal_conv1d(signal[:, None, :], w_sc[:, None, None], b_sc, 1)
    else:
        res = None if residual is None else residual.transpose(1, 2)
    if res is not None:
        y = F.relu(res.float() + y.float()).to(x.dtype)
    return y.transpose(1, 2).contiguous()


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _check(name: str, t: torch.Tensor, shape: tuple) -> None:
    if (t.dtype != torch.bfloat16 or tuple(t.shape) != shape
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                         f"bfloat16 {list(shape)} tensor, got "
                         f"{tuple(t.shape)} {t.dtype}")


def tcn_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             dilation: int, residual: torch.Tensor | None = None,
             shortcut: tuple | None = None) -> torch.Tensor:
    """One fused convolution (module docstring): ``x`` ``[N, T, C_in]``,
    ``weight`` packed ``[C_out, k·C_in]`` (``K = tap·C_in + c_in``) and
    ``bias`` ``[C_out]`` in ``x``'s dtype → ``[N, T, C_out]``."""
    if x.device.type == "cpu":
        return tcn_conv_plain(x, weight, bias, dilation, residual, shortcut)
    if not x.is_cuda:
        raise ValueError(f"x must be a CPU or CUDA tensor, got {x.device}")
    n, t_len, c_in = x.shape
    if c_in not in (1, CHANNELS) or weight.dim() != 2 or weight.shape[1] % c_in:
        raise ValueError(f"x [N, T, 1 or {CHANNELS}] and weight [{CHANNELS}, "
                         f"k*C_in]: got {tuple(x.shape)}, "
                         f"{tuple(weight.shape)}")
    k = weight.shape[1] // c_in
    if c_in == 1 and k > MAX_TAPS_IN:
        raise ValueError(f"a 1-channel convolution takes k <= {MAX_TAPS_IN}")
    _check("x", x, (n, t_len, c_in))
    _check("weight", weight, (CHANNELS, k * c_in))
    _check("bias", bias, (CHANNELS,))
    if residual is not None and shortcut is not None:
        raise ValueError("residual and shortcut are exclusive")
    # the kernel's epilogue: 0 relu, 1 + residual, 2 + signal's shortcut
    mode = 1 if residual is not None else 2 if shortcut is not None else 0
    if c_in == 1 and mode:
        raise ValueError("a 1-channel convolution takes no residual")
    tensors = [x, weight, bias]
    if residual is not None:
        _check("residual", residual, (n, t_len, CHANNELS))
        tensors.append(residual)
    if shortcut is not None:
        signal, w_sc, b_sc = shortcut
        _check("signal", signal, (n, t_len))
        _check("shortcut weight", w_sc, (CHANNELS,))
        _check("shortcut bias", b_sc, (CHANNELS,))
        tensors += [signal, w_sc, b_sc]
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"every tensor must be on {x.device}")
    out = torch.empty((n, t_len, CHANNELS), dtype=x.dtype, device=x.device)
    lib = _build.load("tcn_conv")
    if c_in == 1:
        err = lib.radian_tcn_conv_in(x.data_ptr(), weight.data_ptr(),
                                     bias.data_ptr(), out.data_ptr(), n,
                                     t_len, k, dilation, *_build.target(x))
    else:
        sig, w_sc, b_sc = shortcut if shortcut is not None else (None,) * 3
        err = lib.radian_tcn_conv(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            _ptr(residual), _ptr(sig), _ptr(w_sc), _ptr(b_sc), mode, n, t_len,
            k, dilation, *_build.target(x))
    _build.check(lib, err, "tcn_conv launch")
    profiling.launch(tcn_conv)
    return out


tcn_conv.launches = 0


def packed(conv: CausalConv1D, dtype: torch.dtype):
    """``conv``'s weight packed ``[C_out, k·C_in]`` and its bias, in
    ``dtype``: made once and cached on the module, keyed by each
    parameter's version and storage, so ``load_state_dict``, ``.to`` or
    any in-place update makes them anew.  Parameters made under
    ``inference_mode`` keep no version, so theirs are made every call."""
    w, b = conv.weight, conv.bias
    key = None
    if not (w.is_inference() or b.is_inference()):
        key = (w._version, w.data_ptr(), b._version, b.data_ptr(), dtype)
    cache = getattr(conv, "_packed", None)
    if key is None or cache is None or cache[0] != key:
        with torch.no_grad():
            wp = w.detach().to(dtype).permute(0, 2, 1).reshape(
                w.shape[0], -1).contiguous()
            cache = (key, wp, b.detach().to(dtype).contiguous())
        conv._packed = cache
    return cache[1], cache[2]


def engages(model: nn.Module, x: torch.Tensor, train: bool) -> bool:
    """Whether ``SigToSeq.forward(x, train=train)`` takes the fused path:
    a CUDA ``[N, T, 1]`` input to a model ``fusable`` holds for."""
    return (x.is_cuda and x.dim() == 3 and x.shape[-1] == 1
            and fusable(model, train))


def fusable(model: nn.Module, train: bool) -> bool:
    """The rest of the rule (module docstring): a bf16 model, ``train``
    off, autograd off, and the stack the kernels compute."""
    if (model.compute_dtype != torch.bfloat16 or train
            or torch.is_grad_enabled()):
        return False
    tcn: TCN = model.tcn
    if tcn.use_skip_connections:
        return False
    for i, block in enumerate(tcn.blocks):
        if not (type(block.conv0) is CausalConv1D
                and type(block.conv1) is CausalConv1D
                and block.conv1.weight.shape[:2] == (CHANNELS, CHANNELS)):
            return False
        c_in = block.conv0.weight.shape[1]
        if i == 0:
            if (c_in != 1 or block.conv0.weight.shape[2] > MAX_TAPS_IN
                    or type(block.shortcut) is not CausalConv1D):
                return False
        elif c_in != CHANNELS or block.shortcut is not None:
            return False
    return True


def tcn_forward(tcn: TCN, signal: torch.Tensor) -> torch.Tensor:
    """The stack on ``signal`` ``[N, T]`` (the 1-channel input, in the
    compute dtype) → ``[N, T, 256]`` (``[N, 256]`` without
    ``return_sequences``); ``engages`` has held."""
    dt = signal.dtype
    h = None
    for block in tcn.blocks:
        d = block.conv0.dilation
        w0, b0 = packed(block.conv0, dt)
        w1, b1 = packed(block.conv1, dt)
        if h is None:
            w_sc, b_sc = packed(block.shortcut, dt)
            y = tcn_conv(signal[..., None], w0, b0, d)
            h = tcn_conv(y, w1, b1, d,
                         shortcut=(signal, w_sc.view(-1), b_sc))
        else:
            y = tcn_conv(h, w0, b0, d)
            h = tcn_conv(y, w1, b1, d, residual=h)
    return h if tcn.return_sequences else h[:, -1]
