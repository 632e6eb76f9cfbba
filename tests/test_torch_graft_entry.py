"""The port's graft entry points (``adlb_tpu_torch/graft_entry.py``) on the
CPU, against the JAX package's (``__graft_entry__.py``).

* ``entry()`` builds the JAX entry's instance (same seed, same shape) and
  its solve returns the same assignment array as the JAX entry's Pallas
  solve (interpret mode on the CPU): exact equality, integer task indices.
* ``dryrun_multichip(n, device="cpu")`` passes its own assertions (pairs
  that respect the type masks, an engine round with matches and
  migrations) over n logical shards, where the JAX package's
  ``test_graft_entry.py::test_dryrun_multichip_8`` cannot build its mesh
  tier under the installed jax.
* ``device="cuda"`` without a card raises: no fallback.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU platform)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import __graft_entry__ as ref_graft  # noqa: E402
from adlb_tpu_torch import graft_entry  # noqa: E402


def test_entry_equals_the_jax_entry():
    fn, args = graft_entry.entry(device="cpu")
    ref_fn, ref_args = ref_graft.entry()
    for a, b in zip(args, ref_args):
        assert np.array_equal(a.numpy(), np.asarray(b))
    got = fn(*args)
    assert got.dtype == torch.int32 and got.shape == (8 * 32,)
    assert np.array_equal(got.numpy(), np.asarray(ref_fn(*ref_args)))
    assert (got >= 0).sum() > 0


@pytest.mark.parametrize("n", [4, 6, 8])
def test_dryrun_multichip_on_logical_shards(n):
    got = graft_entry.dryrun_multichip(n, device="cpu")
    assert got["pairs"] and got["matches"] and got["migrations"]
    assert got["device_plans"] >= 2


def test_main_runs_on_the_cpu(capsys):
    assert graft_entry.main(["--device", "cpu", "--n", "8"]) == 0
    out = capsys.readouterr().out
    assert "entry() solve: (256,)" in out and "8 logical shards" in out


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(8)
