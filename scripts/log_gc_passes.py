"""Run a script (chip_smoke.py by default) with Python's cycle collector
logged: every pass of generation 2, and every other pass over 5 ms, is
printed on stdout as `[gc] generation G pass T ms, collected N`, in order
with the script's own lines, so a slow frame can be set beside the passes
around it.

    python3 scripts/log_gc_passes.py [script.py [arguments]]

Run it from the directory that holds the script.
"""

import gc
import runpy
import sys
import time

_start = [0.0]


def _clock(event: str, info: dict) -> None:
    if event == "start":
        _start[0] = time.perf_counter()
        return
    ms = (time.perf_counter() - _start[0]) * 1e3
    if ms > 5 or info["generation"] == 2:
        print(f"[gc] generation {info['generation']} pass {ms:.2f} ms, collected "
              f"{info['collected']}", flush=True)


def main() -> None:
    sys.argv = sys.argv[1:] or ["chip_smoke.py"]
    gc.callbacks.append(_clock)
    runpy.run_path(sys.argv[0], run_name="__main__")


if __name__ == "__main__":
    main()
