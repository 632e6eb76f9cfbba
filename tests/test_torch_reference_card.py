"""The JAX package's suites whose worlds plan with ``balancer="tpu"``, run
unchanged against the port with the device ``"cuda"`` and the host
threshold 0, so that their planned worlds solve through the greedy-sweep
kernel on the card (``tests/torch_reference.py``): in the pytest process,
one launch per device solve, none on the host, and the kept solves equal
to the numpy twin. They skip without a CUDA device. This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_reference_card.py
"""

import pytest

from torch_reference import CARD_FILES, run_reference_file

#: the pytest process keeps every CHECK_EVERY-th device solve of each
#: solver and holds it against the numpy twin ``_host_greedy``
CHECK_EVERY = 8


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_FILES)
def test_reference_suite_passes_on_the_card(card, name, tmp_path,
                                            monkeypatch):
    monkeypatch.setenv("ADLB_CHECK_SOLVES", str(CHECK_EVERY))
    counts = run_reference_file(name, "cuda", str(tmp_path),
                                host_threshold=0)["kernels"]
    assert counts["greedy_sweep_launches"] == counts["device_solves"], \
        counts
    assert counts["host_solves"] == counts["solves_wrong"] == 0, counts
    assert counts["solves_checked"] >= counts["device_solves"] \
        // CHECK_EVERY, counts
