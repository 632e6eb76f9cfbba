"""Native core: C++ implementations of the hot server paths.

Built on demand with the system toolchain (g++ only; no pip/pybind11) and
loaded via ctypes. Everything here has a pure-Python fallback — the native
path is a drop-in accelerator, never a requirement.
"""

from adlb_tpu_torch.native.build import ensure_built, native_available  # noqa: F401
from adlb_tpu_torch.native.wq import NativeWorkQueue  # noqa: F401
