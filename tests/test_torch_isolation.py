"""The port stays free of JAX, and its tests keep torch out of collection."""

import os
import re
import subprocess
import sys
from pathlib import Path

from tests.torch_one_cpu import one_cpu  # noqa: F401  (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "radian_tpu_torch"


def test_import_leaves_jax_out():
    code = (
        "import sys, pkgutil, importlib, radian_tpu_torch\n"
        "for m in pkgutil.walk_packages(radian_tpu_torch.__path__, "
        "'radian_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'radian_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'radian_tpu_torch.lm.kmer' in sys.modules\n"
        "for m in ('train.trainer', 'train.data', 'train.optimizers', "
        "'cli.train', 'ops.ctc', 'ops.greedy', 'io.tfrecord', "
        "'utils.tensorboard', 'parallel.mesh', 'parallel.distributed', "
        "'eval.align', 'eval.accuracy', 'utils.profiling', "
        "'utils.inspect', 'utils.viz', 'ops.beam_native', "
        "'models.tensor_parallel'):\n"
        "    assert 'radian_tpu_torch.' + m in sys.modules, m\n"
        "assert 'radian_tpu_torch.models.keras_import' in sys.modules\n"
        "assert 'h5py' not in sys.modules  # imported where it is used\n"
        "assert 'matplotlib' not in sys.modules  # the same\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_forbidden_imports():
    """No file of the port (or chip_smoke.py) imports JAX or the JAX
    package, and its native sources and build paths stay inside it: no
    C++ or CUDA source includes a file of ``radian_tpu/`` (or any path
    outside ``csrc/``; comments may name the kernel a source replaces),
    each library is built from ``radian_tpu_torch/csrc`` into
    ``radian_tpu_torch/_build``, and its flags (the host decoder's
    ``-fopenmp`` too) are in its file name's hash.  No test module imports torch or the
    port at module level: collection imports every test module into
    every xdist worker, which would load torch beside
    tests/test_train.py (see tests/torch_one_cpu.py)."""
    from radian_tpu_torch import _build

    pat = re.compile(r"^\s*(import|from)\s+"
                     r"(jax|jaxlib|flax|optax|orbax|radian_tpu)\b", re.M)
    files = list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in ("lm/kmer.py", "train/trainer.py", "train/data.py",
              "train/optimizers.py", "cli/train.py", "ops/ctc.py",
              "ops/greedy.py", "io/tfrecord.py", "utils/tensorboard.py",
              "parallel/mesh.py", "parallel/distributed.py",
              "eval/align.py", "eval/accuracy.py", "utils/profiling.py",
              "utils/inspect.py", "utils/viz.py", "ops/beam_native.py",
              "models/tensor_parallel.py"):
        assert PKG / f in files, f
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders
    sources = sorted((PKG / "csrc").iterdir())
    assert PKG / "csrc" / "seqmatch.cc" in sources
    assert PKG / "csrc" / "tfrecord.cc" in sources
    assert PKG / "csrc" / "beamsearch.cc" in sources
    offenders = [f.name for f in sources
                 if re.search(r'^\s*#\s*include\s*["<][^">]*(radian_tpu/|\.\.)',
                              f.read_text(), re.M)]
    assert not offenders, offenders
    for name in ("beam_search", "beam_search_lm", "seqmatch", "tfrecord",
                 "beamsearch"):
        assert _build._source(name).parent == PKG / "csrc"
        assert _build._target(name).parent == PKG / "_build"
    # the build flags: one set a compiler, the host decoder's OpenMP on
    # top of the host set, every set hashed into its library's name
    gxx = _build._flags(_build._source("tfrecord"))
    assert _build._flags(_build._source("beamsearch")) == [*gxx, "-fopenmp"]
    assert "-fopenmp" not in gxx
    assert "sm_90a" in " ".join(_build._flags(_build._source("beam_search")))
    target = _build._target("beamsearch")
    _build.GXX_EXTRA_FLAGS["beamsearch"].append("-g")
    try:
        assert _build._target("beamsearch") != target
    finally:
        _build.GXX_EXTRA_FLAGS["beamsearch"].pop()
    pat = re.compile(r"^(import|from)\s+(torch|radian_tpu_torch)\b", re.M)
    offenders = [f.name for f in (REPO / "tests").glob("*.py")
                 if pat.search(f.read_text())]
    assert not offenders, offenders
