"""The open-loop sender of the serving cell, a process of its own so that
its timing shares no interpreter with the system under test.

It reads one JSON line from standard input, {"t0": <time.monotonic()>,
"due": [seconds after t0, ...]}, and writes the index of each request to
standard output, one line each, when it is due; then it exits. It imports
nothing but the standard library.
"""

import json
import sys
import time


def main() -> None:
    plan = json.loads(sys.stdin.readline())
    t0, out = plan["t0"], sys.stdout
    for j, due in enumerate(plan["due"]):
        left = t0 + due - time.monotonic()
        if left > 0:
            time.sleep(left)
        out.write(f"{j}\n")
        out.flush()


if __name__ == "__main__":
    main()
