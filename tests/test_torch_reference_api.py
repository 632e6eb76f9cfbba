"""The JAX package's suites of the API and the queues (put, reserve, get_work,
iput, fused delivery), run unchanged against the port on the CPU, one case
per reference file (``tests/torch_reference.py``)."""

import pytest

from torch_reference import GROUPS, run_reference_file


@pytest.mark.parametrize("name", GROUPS["api"])
def test_reference_suite_passes_on_the_port(name, tmp_path):
    run_reference_file(name, "cpu", str(tmp_path))
