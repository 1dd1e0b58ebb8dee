"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Exits non-zero without a result line when no
card (or fewer than the cell's chips) is present, when JAX or the JAX
package is loaded, or when the program is missing. Its caches stay in the
checkout: the program's kernels in build/torch_kernels (where the program
builds them), Triton's, PyTorch's extensions' and inductor's under build/.
The program's own console output goes to standard error; standard output
holds the card's line, the launches and the window, and last the result
line.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
for _name, _dir in (("TRITON_CACHE_DIR", "triton_cache"),
                    ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                    ("TORCHINDUCTOR_CACHE_DIR", "torchinductor")):
    os.environ[_name] = os.path.join(ROOT, "build", _dir)
os.environ["USE_FLAX"] = "0"

if __name__ == "__main__":
    from benchmark.harness import core

    stdout, sys.stdout = sys.stdout, sys.stderr
    sys.exit(core.run(core.parser().parse_args(), T_START, stdout))
