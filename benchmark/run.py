"""``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell (``benchmark/harness.py``)."""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402


def process_age(now: float) -> float:
    """Seconds since this process started (Linux ``/proc``; 0 where it
    cannot be read), so that ``setup_s`` counts the interpreter's start."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    return max(0.0, age - (time.perf_counter() - now))


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    from benchmark.harness import main
    sys.exit(main(t0=T0 - process_age(T0)))
