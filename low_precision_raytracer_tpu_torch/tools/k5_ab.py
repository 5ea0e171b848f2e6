"""K5 of this checkout beside other checkouts' K5, on colonnade-83k's
recorded 1920x1080 wavefront launches (bf16, 'rounds' then 'oneshot').

    python3 -m low_precision_raytracer_tpu_torch.tools.k5_ab NAME=DIR [NAME=DIR ...]

from the root of this checkout, on one GPU.  Each DIR is another checkout
of the repository (`git archive` into an ignored directory, or such a copy
with one source edited); its K5 wrapper and kernel are loaded as
`chip_smoke.py --beside` loads them.  Every call of each launch is held
bit for bit against the plain version (`chip_smoke.k5_hold`, with the
emulation on a slice) and every other checkout's result against it, then
all are timed in the order this, the others, and back (`chip_smoke.ab_ms`,
9 rounds).  One JSON line per call: per checkout the median ms and the
least and greatest sample; the card's name and power limit first.
"""

from __future__ import annotations

import inspect
import json
import statistics
import subprocess
import sys


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available() or not argv:
        print("k5_ab: needs a CUDA device and NAME=DIR arguments", file=sys.stderr)
        return 1
    sys.path.insert(0, ".")
    import chip_smoke as C

    from low_precision_raytracer_tpu_torch.config import RenderConfig
    from low_precision_raytracer_tpu_torch.ops import cuda_lib
    from low_precision_raytracer_tpu_torch.ops import wavefront as WF
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    C.ptxas_report(cuda_lib.build_all())
    others = {}
    for arg in argv:
        name, root = arg.split("=", 1)
        others[name] = C.load_beside(root).wavefront
    for mode in ("rounds", "oneshot"):
        warm = Renderer(C.colonnade_83k(), RenderConfig(width=C.W, height=C.H, precision="bf16",
                                                        wavefront_mode=mode))
        calls = C.capture_big_launches(warm, 2)
        del warm
        for kind, (_n, args, kw) in zip(("gi", "shadow1"), calls[2:]):
            for n, (a, k, _ray) in enumerate(C.record_k5(args, kw)):
                name = f"{mode} {kind} call {n}"
                _got, _counts, ref, _plain_ms, _n_emu = C.k5_hold(name, a, k,
                                                                  check_emulation=True)
                fns = {"this": lambda: WF.assigned_test(*a, **k)}
                for o, mod in others.items():
                    # a checkout older than the slice culling takes no slices
                    ko = k if "slices" in inspect.signature(mod.assigned_test).parameters else {}
                    fns[o] = lambda mod=mod, ko=ko: mod.assigned_test(*a, **ko)
                    if not all(torch.equal(x, y) for x, y in zip(fns[o](), ref)):
                        raise AssertionError(f"{name}: {o} differs from the plain version")
                samples = C.ab_ms(list(fns.values()), C.sample_reps(fns["this"]), rounds=9)
                print(json.dumps(dict(
                    call=name, lanes=int(a[5].shape[0]), q=int(a[5].shape[1]),
                    find_any=bool(a[-1]),
                    **{o: [statistics.median(s), s[0], s[-1]] for o, s in zip(fns, samples)})),
                    flush=True)
        del calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
