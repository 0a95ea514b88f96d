"""The yardstick alone: the inputs are a function of the seed, the
counts equal hand counts, the trace reduction adds up, and the frozen
reference agrees with the port on the CPU."""

import types

import numpy as np
import pytest

from benchmark.core import counts, inputs
from benchmark.core import reference as plain
from benchmark.core import trace

TRAFFIC = {"reads_per_call": 5, "distinct_calls": 3, "length_min": 400,
           "length_max": 900, "level_seed": 7, "markov_p": 0.9,
           "dwell_mean": 10.0, "dwell_std": 2.0, "noise": 0.12,
           "adc_scale": 100.0, "adc_offset": 500.0, "pool_batches": 2,
           "read_windows": 2.2, "max_label": 64}


def test_reads_are_a_function_of_the_seed():
    a = inputs.read_calls(2**31 + 7, TRAFFIC)
    b = inputs.read_calls(2**31 + 7, TRAFFIC)
    c = inputs.read_calls(8, TRAFFIC)
    flat = [r for call in a for r in call]
    assert all(np.array_equal(x, y) for x, y in
               zip(flat, [r for call in b for r in call]))
    assert not all(np.array_equal(x, y) for x, y in
                   zip(flat, [r for call in c for r in call]))
    # every seed: the same set of lengths, each call an even share
    lens = sorted(len(r) for r in flat)
    assert lens == sorted(len(r) for call in c for r in call)
    assert lens == sorted(np.round(np.linspace(400, 900, 15)).astype(int))
    assert all(r.dtype == np.int16 for r in flat)


def test_training_batches_are_a_function_of_the_seed():
    a = inputs.train_batches(11, TRAFFIC, 4, 256, 4.0)
    b = inputs.train_batches(11, TRAFFIC, 4, 256, 4.0)
    c = inputs.train_batches(12, TRAFFIC, 4, 256, 4.0)
    for k in a[0]:
        assert np.array_equal(a[1][k], b[1][k])
    assert not np.array_equal(a[0]["signal"], c[0]["signal"])
    rows = np.concatenate([x["signal"] for x in a])
    assert len(np.unique(rows, axis=0)) == len(rows)  # every row differs
    assert (a[0]["label_length"] > 0).all()


def test_markov_lm_is_the_ports():
    from radian_tpu_torch.utils.synthetic import markov_kmer_lm

    probs, ent = inputs.markov_lm_tables(0.9, 5)
    lm = markov_kmer_lm(inputs.markov_trans(0.9), 5)
    assert np.array_equal(probs, lm.probs)
    assert np.array_equal(ent, lm.entropy)


def test_model_flops_equal_a_hand_count():
    model = {"relu_units": 4, "softmax_units": 5,
             "tcn": {"nb_filters": 8, "kernel_size": 3, "nb_stacks": 1,
                     "dilations": [1, 2]}}
    # block 0: 1→8 k3 + 8→8 k3 + 1→8 1×1; block 1: two 8→8 k3; dense
    hand = 2 * (3 * 8 + 3 * 64 + 8 + 2 * 3 * 64 + 8 * 4 + 4 * 5)
    assert counts.model_flops_per_sample(model) == hand
    assert counts.train_flops_per_window(model, 10) == 3 * 10 * hand


def test_full_model_flops_are_twice_its_kernels():
    from benchmark.tests.tiny import ROOT

    w = inputs.load_weights(ROOT / "benchmark/data/radian_sig2seq_trained.npz")
    n = sum(v.size for k, v in w.items() if k.endswith("kernel"))
    model = {"relu_units": 128, "softmax_units": 5,
             "tcn": {"nb_filters": 256, "kernel_size": 3, "nb_stacks": 1,
                     "dilations": [1, 2, 4, 8, 16, 32]}}
    assert counts.model_flops_per_sample(model) == 2 * n == 4_394_240
    assert sum(v.size for v in w.values()) == 2_200_581


def test_decode_counts_equal_hand_counts():
    assert counts.decode_ops_per_step(6, False) == 29 * 36 + 83 * 6
    assert counts.decode_ops_per_step(6, True) == (29 * 36 + 83 * 6
                                                   + 47 * 6 + 35)
    assert counts.decode_bytes(100, 6, 7, 10) == 100 * (20 + 12) + 70
    t, by = counts.decode_bound_s(10**6, 6, True, 10, 10)
    assert by == "operations" and t == pytest.approx(10**6 * 1859 / 67e12)


def _ev(name, start, dur, cuda=False):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur,
        device_type=lambda: DeviceType.CUDA if cuda else DeviceType.CPU)


def test_trace_reduction_adds_up():
    ev = [_ev(trace.WINDOW_SPAN, 1000, 10_000),
          _ev("aten::conv", 1000, 3000),
          _ev("k1", 2000, 2000, True), _ev("k2", 3000, 2000, True),
          _ev("cpu_gap_op", 5000, 3000),
          _ev("k3", 8000, 1000, True), _ev("before", 0, 1500, True),
          _ev(trace.WINDOW_SPAN, 1000, 10_000, True)]
    t = trace.reduce(ev)
    assert t.window_s == pytest.approx(10e-6)
    # busy: [1000,1500) clipped + [2000,5000) + [8000,9000)
    assert t.busy_s == pytest.approx(0.5e-6 + 3e-6 + 1e-6)
    assert sum(d for _, d in t.gaps) == pytest.approx(10e-6 - t.busy_s)
    assert dict(t.top_gaps())["cpu_gap_op"] == pytest.approx(3e-6)
    assert t.device_seconds("k1", "k2") == pytest.approx(4e-6)


def test_reference_decode_equals_the_ports_plain_decoder():
    import torch

    from radian_tpu_torch.ops.beam_search import beam_search_batch

    rng = np.random.default_rng(3)
    mats = [rng.dirichlet(np.full(5, 0.3), size=n).astype(np.float32)
            for n in (90, 140, 60)]
    # exact ties and exact zeros: the selection's tie rule and log(0)
    mats[2] = (np.round(mats[2] * 4) / 4).astype(np.float32)
    probs, ent = inputs.markov_lm_tables(0.9, 3)
    rows4, ent4 = inputs.markov_lm_rows(0.9)
    lm = plain.Lm(torch.from_numpy(np.concatenate([rows4, ent4[:, None]],
                                                  1)), 3, 0.5, 0.5)
    for fusion in (None, lm):
        got = plain.beam_search(mats, 6, "cpu", fusion)
        pad = np.zeros((3, 140, 5), np.float32)
        for j, m in enumerate(mats):
            pad[j, :len(m)] = m
        rev, _, _ = beam_search_batch(
            torch.from_numpy(pad), torch.tensor([90, 140, 60]), 6,
            lm_probs=torch.from_numpy(probs), lm_ent=torch.from_numpy(ent),
            ctx_len=3, lm_enabled=fusion is not None)
        want = ["".join("ACGT"[x] for x in r if x >= 0)
                for r in rev.numpy()]
        assert got == want


def test_reference_consensus_equals_the_ports_plain_one():
    from radian_tpu_torch.ops.consensus import assemble_fragments

    rng = np.random.default_rng(4)
    read = "".join(rng.choice(list("ACGT"), 200))
    frags = [read[i:i + 40] for i in range(0, 170, 6)]
    frags[3] = frags[3][:10] + "A" + frags[3][11:]
    assert plain.consensus(frags) == assemble_fragments(frags, native=False)


def test_reference_forward_equals_the_ports_model():
    import torch

    from radian_tpu_torch.models.checkpoint import params_from_flax
    from radian_tpu_torch.models.sig2seq import SigToSeq

    model = {"relu_units": 8, "softmax_units": 5,
             "tcn": {"nb_filters": 8, "kernel_size": 3, "nb_stacks": 1,
                     "dilations": [1, 2, 4]}}
    w = inputs.seeded_weights(5, model, torch.device("cpu"))
    w = {k: v + 0.01 * (k.endswith("bias")) for k, v in w.items()}
    net = SigToSeq(8, 5, 8, 3, 1, (1, 2, 4))
    net.load_state_dict(params_from_flax(w))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3, 300)).astype(np.float32))
    want = net(x[..., None], probs=True)
    got = plain.forward(plain.torch_params(w, model, "cpu"), model, x)
    assert torch.allclose(got, want, atol=1e-6)
    assert plain.receptive_field(model) == net.receptive_field


def test_rounding_is_the_named_precision():
    import torch

    x = torch.tensor([1.0 + 2**-12, 1.0 + 2**-9, 300.0, -0.3])
    assert plain.round_to(x, "tf32")[0] == 1.0
    assert plain.round_to(x, "tf32")[1] == 1.0 + 2**-9
    assert torch.equal(plain.round_to(x, "bf16"), x.bfloat16().float())
    f8 = plain.round_to(x, "fp8")
    assert (f8 - x).abs().max() / x.abs().max() < 2**-3
    assert plain.round_to(x, None) is x
