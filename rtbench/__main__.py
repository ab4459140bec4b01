import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# Kernel caches at fixed paths inside the checkout.
_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")

from rtbench.run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
