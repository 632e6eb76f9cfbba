"""The JAX package's suites of the balancer and the workloads, run unchanged
against the port on the CPU, one case per reference file
(``tests/torch_reference.py``)."""

import pytest

from torch_reference import GROUPS, run_reference_file


@pytest.mark.parametrize("name", GROUPS["workloads"])
def test_reference_suite_passes_on_the_port(name, tmp_path):
    run_reference_file(name, "cpu", str(tmp_path))
