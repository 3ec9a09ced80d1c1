"""Schedule and CPU use of one Tier-1 test run (``ROADMAP.md``, F15).

Runs the Tier-1 pytest command (6 xdist workers, ``--dist loadfile``) with
``-v``, stamps each output line with the time it arrived and samples the
host's CPU counters (``/proc/stat``) every few seconds.  Prints, for each
worker, the files it ran with the times (seconds from the start) of their
first and last finished test, then the host's busy share per minute and
the wall.  The run's log, junit XML and CPU samples go under ``--out``.

    python tier1_timeline.py [--out DIR] [--timeout 1470] [paths ...]

(``paths``: the test paths, ``tests/`` by default.)

Read with care: a file's span starts at its FIRST FINISHED test, not when
its worker picked it up.
"""

import argparse
import collections
import os
import re
import signal
import subprocess
import sys
import threading
import time

PYTEST = [sys.executable, "-m", "pytest", "-v", "-m", "not slow",
          "--continue-on-collection-errors", "-p", "no:cacheprovider",
          "-p", "xdist", "-n", "6", "--dist", "loadfile", "-p", "no:randomly"]
LINE = re.compile(r"\[(gw\d+)\] \[\s*\d+%\] \w+ (tests/[^:]+)::")


def cpu_sampler(samples, stop, every=5.0):
    """Append ``(time, busy jiffies, total jiffies)`` of the host's first
    ``/proc/stat`` line until ``stop`` is set."""
    while not stop.is_set():
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:]]
        samples.append((time.time(), sum(v) - v[3] - v[4], sum(v)))
        stop.wait(every)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="results/tier1_timeline")
    ap.add_argument("--timeout", type=float, default=1470.0)
    ap.add_argument("paths", nargs="*", default=["tests/"])
    a = ap.parse_args()
    os.makedirs(a.out, exist_ok=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu", ALLOW_MULTIPLE_LIBTPU_LOAD="1")
    samples, stop = [], threading.Event()
    threading.Thread(target=cpu_sampler, args=(samples, stop),
                     daemon=True).start()
    t0 = time.time()
    spans = collections.OrderedDict()
    cmd = PYTEST + a.paths + ["--junitxml", os.path.join(a.out, "junit.xml")]
    with open(os.path.join(a.out, "pytest.log"), "w") as log, \
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, env=env, text=True,
                             errors="replace", start_new_session=True) as p:
        # the time limit ends pytest and its workers
        timer = threading.Timer(a.timeout, os.killpg, (p.pid, signal.SIGKILL))
        timer.start()
        for line in p.stdout:
            t = time.time() - t0
            log.write(f"{t:.2f} {line}")
            m = LINE.search(line)
            if m:
                s = spans.setdefault(m.groups(), [t, t, 0])
                s[1], s[2] = t, s[2] + 1
        rc = p.wait()
        timer.cancel()
    wall = time.time() - t0
    stop.set()
    byw = collections.defaultdict(list)
    for (w, f), (first, last, n) in spans.items():
        byw[w].append(f"{os.path.basename(f)[:-3]} {first:.0f}-{last:.0f}"
                      f" ({n})")
    for w in sorted(byw, key=lambda w: int(w[2:])):
        print(w, " | ".join(byw[w]))
    busy = collections.defaultdict(list)
    with open(os.path.join(a.out, "cpu.txt"), "w") as f:
        for (ta, ba, na), (tb, bb, nb) in zip(samples, samples[1:]):
            share = (bb - ba) / max(nb - na, 1)
            f.write(f"{ta - t0:.1f} {share:.4f}\n")
            busy[int((ta - t0) // 60)].append(share)
    print("host busy % per minute:", " ".join(
        f"{k}:{100 * sum(v) / len(v):.0f}" for k, v in sorted(busy.items())))
    print(f"pytest rc={rc} wall={wall:.1f} s")


if __name__ == "__main__":
    main()
