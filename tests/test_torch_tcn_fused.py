"""The fused channels-last TCN path (``ops/tcn_conv.py``) on the CPU.

Its plain version must equal today's ``ResidualBlock`` bit for bit, in
bf16 and in f32 (block 0 with its 1-channel input and shortcut, a
256-channel block at dilations 1 and 32, T off the kernel's 128-row
tile), and the rule that picks the fused path must refuse every input
the kernels do not take.  The CUDA kernel itself is held against the
plain version on the card by ``chip_smoke.py``.  ``torch`` and the port
are imported inside the tests (see ``tests/torch_one_cpu.py``).
"""

from pathlib import Path

import numpy as np

from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

TRAINED = Path(__file__).resolve().parents[1] / "bench_data" / "trained" / "params.npz"
T_LEN = 300  # not a multiple of the kernel's 128-row tile


def _trained_model(dtype):
    from radian_tpu_torch.models.checkpoint import (
        load_params_npz,
        params_from_flax,
    )
    from radian_tpu_torch.models.sig2seq import build_model

    model = build_model(compute_dtype=dtype)
    model.load_state_dict(params_from_flax(load_params_npz(TRAINED)))
    return model.eval()


def _signal(dtype):
    import torch

    x = np.random.default_rng(0).normal(size=(2, T_LEN)).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


def test_plain_channels_last_equals_residual_block_bit_for_bit():
    import torch

    from radian_tpu_torch.models.tcn import ResidualBlock
    from radian_tpu_torch.ops import tcn_conv as tc

    for dtype in (torch.bfloat16, torch.float32):
        model = _trained_model(dtype)
        sig = _signal(dtype)
        blocks = {d: ResidualBlock(256, 256, 3, d).to(dtype) for d in (1, 32)}
        for block in blocks.values():
            block.load_state_dict(model.tcn.blocks[1].state_dict())
        with torch.inference_mode():
            # block 0: 1 -> 256 channels, its shortcut recomputed
            b0 = model.tcn.blocks[0]
            want, _ = b0(sig[:, None, :])
            w0, bias0 = tc.packed(b0.conv0, dtype)
            w1, bias1 = tc.packed(b0.conv1, dtype)
            w_sc, b_sc = tc.packed(b0.shortcut, dtype)
            d = b0.conv0.dilation
            y = tc.tcn_conv(sig[..., None], w0, bias0, d)
            h = tc.tcn_conv(y, w1, bias1, d,
                            shortcut=(sig, w_sc.view(-1), b_sc))
            assert h.shape == (2, T_LEN, 256) and h.is_contiguous()
            assert torch.equal(h, want.transpose(1, 2)), dtype
            # a 256-channel block at dilations 1 and 32, on block 0's output
            for d, block in blocks.items():
                want, _ = block(h.transpose(1, 2))
                w0, bias0 = tc.packed(block.conv0, dtype)
                w1, bias1 = tc.packed(block.conv1, dtype)
                y = tc.tcn_conv(h, w0, bias0, d)
                got = tc.tcn_conv(y, w1, bias1, d, residual=h)
                assert torch.equal(got, want.transpose(1, 2)), (dtype, d)
            # the whole stack, and the model's output on its usual path
            stack = tc.tcn_forward(model.tcn, sig)
            assert torch.equal(stack,
                               model.tcn(sig[:, None, :]).transpose(1, 2))
    assert tc.tcn_conv.launches == 0


def test_fused_path_rule_and_cpu_wrapper():
    import torch

    from radian_tpu_torch.models.checkpoint import params_to_flax
    from radian_tpu_torch.models.tensor_parallel import shard_model
    from radian_tpu_torch.ops import tcn_conv as tc
    from radian_tpu_torch.parallel import make_mesh, param_shardings

    bf16, f32 = _trained_model(torch.bfloat16), _trained_model(torch.float32)
    x = _signal(torch.float32)[..., None]
    with torch.inference_mode():
        assert tc.fusable(bf16, train=False)
        assert not tc.fusable(bf16, train=True)
        assert not tc.engages(bf16, x, train=False)  # a CPU tensor
        assert not tc.fusable(f32, train=False)
        mesh = make_mesh(1, 2, ["cpu", "cpu"])
        sharded = _trained_model(torch.bfloat16)
        shard_model(sharded, mesh.model_row(0),
                    param_shardings(params_to_flax(sharded), mesh))
        assert not tc.fusable(sharded, train=False)
    with torch.enable_grad():
        assert not tc.fusable(bf16, train=False)

    # the wrapper given CPU tensors returns the plain result
    conv = bf16.tcn.blocks[2].conv0
    w, b = tc.packed(conv, torch.bfloat16)
    h = torch.randn(2, T_LEN, 256, generator=torch.Generator().manual_seed(1))
    h = h.to(torch.bfloat16)
    got = tc.tcn_conv(h, w, b, conv.dilation, residual=h)
    assert torch.equal(got, tc.tcn_conv_plain(h, w, b, conv.dilation,
                                              residual=h))
    assert tc.tcn_conv.launches == 0
    # the packed weights follow an in-place update of the parameters
    assert tc.packed(conv, torch.bfloat16)[0] is w
    with torch.no_grad():
        conv.weight.mul_(2.0)
    w2, _ = tc.packed(conv, torch.bfloat16)
    assert w2 is not w
    assert torch.equal(w2, (conv.weight.to(torch.bfloat16).permute(0, 2, 1)
                            .reshape(256, -1)))
