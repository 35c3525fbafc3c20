#!/usr/bin/env python3
"""Run another checkout's ``chip_smoke.py`` with each of its phases timed.

``chip_smoke.py`` prints a ``phase_times`` line of its own; a checkout from
before that line does not.  This runs such a checkout's script whole, its
``phase_*`` functions each wrapped in a wall clock, and prints their
seconds as one JSON line after the script's own last line:

    git archive <commit> | tar -x -C build/parent
    python3 smoke_phase_times.py build/parent

Compare two trees only inside one call on one card: the host's speed
moves the script's time by a fifth from one machine to the next.
"""
import json
import os
import sys
import time

if __name__ == "__main__":
    root = os.path.abspath(sys.argv[1])
    # the checkout's own script and package; its rank processes (spawn
    # start method) import the script by this name
    sys.path[:0] = [root, os.path.join(root, "src")]
    import chip_smoke

    times = {}
    for name in [n for n in dir(chip_smoke) if n.startswith("phase_")]:
        fn = getattr(chip_smoke, name)

        def timed(*args, _fn=fn, _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kw)
            finally:
                times[_name] = times.get(_name, 0.0) + (
                    time.perf_counter() - t0)
        setattr(chip_smoke, name, timed)
    t0 = time.perf_counter()
    os.chdir(root)
    rc = chip_smoke.main([])
    print(json.dumps({"phase_times": times,
                      "seconds": time.perf_counter() - t0, "rc": rc}))
    sys.exit(rc)
