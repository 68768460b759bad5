"""Single-command multi-process fan-out for the rank-strided CLIs (the port's
own copy of ``versband_tpu/utils/fanout.py:22-58``).

The reference spawns one worker per GPU (``scripts/test_final.py:467-477``);
the CLIs shard work with ``--rank/--world`` instead. ``--nproc N`` re-runs
the same CLI N times with the rank flags appended and waits for all of them.
On a one-card host pass ``--platform cpu`` so that the children do not all
take the card.
"""

from __future__ import annotations

import subprocess
import sys
from typing import Iterable, List, Optional


def strip_flag(argv: Iterable[str], flag: str) -> List[str]:
    """Remove ``flag <value>`` / ``flag=value`` occurrences from an argv."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == flag:
            skip = True
            continue
        if a.startswith(flag + "="):
            continue
        out.append(a)
    return out


def spawn_ranks(module: str, argv: Iterable[str], nproc: int,
                extra_env: Optional[dict] = None) -> int:
    """Run ``python -m <module> <argv> --rank i --world nproc`` x nproc.

    Children stream to this process's stdout/stderr. Returns the max child
    return code (0 iff all succeeded).
    """
    import os

    argv = strip_flag(list(argv), "--nproc")
    procs = []
    env = {**os.environ, **(extra_env or {})}
    for r in range(nproc):
        cmd = [sys.executable, "-m", module, *argv,
               "--rank", str(r), "--world", str(nproc)]
        procs.append(subprocess.Popen(cmd, env=env))
    rcs = [p.wait() for p in procs]
    for r, rc in enumerate(rcs):
        if rc:
            print(f"[fanout] rank {r} exited {rc}", file=sys.stderr)
    return max(rcs)
