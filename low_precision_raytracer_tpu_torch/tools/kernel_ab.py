"""One kernel of this checkout beside the same kernel of other checkouts,
on recorded 1920x1080 launches of the main path.

    python3 -m low_precision_raytracer_tpu_torch.tools.kernel_ab KERNEL NAME=DIR [NAME=DIR ...]

from the root of this checkout, on one GPU.  KERNEL is
- `k1a`: K1a on the flagship's launches (Cornell: bf16, fp32, fp16, the
  packed epilogue, bf16 'both' and 'dtype'), every launch held against the
  plain version on every ray (`chip_smoke.check_dense`); the bf16 launches
  also timed without their fused shadow phase (the closest-hit loop alone);
- `k5`: K5 on colonnade-83k's wavefront launches (bf16, 'rounds' then
  'oneshot'), every call held bit for bit (`chip_smoke.k5_hold`, with the
  emulation on a slice), a checkout older than the slice culling called
  without the slices;
- `walk`: the BVH walk (`trace_rays`) on the launches of Cornell under
  'jax' (fp32 'both', fp16 'both' and 'dtype', bf16 'both'), colonnade-5k
  under 'jax' and colonnade-8M (bf16), every launch of every checkout held
  bit for bit against this checkout's reference walk
  (`trace_rays_reference`), which is timed beside them;
- `tool`: the Q2.4 tool's two chunk bodies (`tools/mxu_proto.py`: `vpu`,
  `mxu`) on its 1080p case at TC 48, NCHUNK 1 and 8, every checkout's
  bodies held against this checkout's plain versions on a 2^14-ray slice
  as `chip_smoke.tool_phase` holds them; first, each checkout's SASS
  (`cuobjdump -sass` of its built library): per kernel of the tool, its
  innermost loops with their instructions, MUFU.RCP (the divides'
  reciprocals) and tensor-core instructions.
Each DIR is another checkout of the repository (`git archive` into an
ignored directory, or such a copy with one source edited); its wrappers
and kernels are loaded as `chip_smoke.py --beside` loads them, and every
checkout's result is held like this one's.  All are timed in the order
this, the others, and back (`chip_smoke.ab_ms`).  One JSON line per launch
or call: per checkout the median ms and the least and greatest sample;
the card's name and power limit first.
"""

from __future__ import annotations

import inspect
import json
import statistics
import subprocess
import sys

K1A_CASES = (("bf16", {}), ("fp32", {}), ("fp16", {}), ("bf16", {"dense_epilogue": "pack"}),
             ("bf16", {"triangle_fallback": "both"}), ("bf16", {"triangle_fallback": "dtype"}))


def report(what, fns, samples):
    print(json.dumps(dict(**what, **{o: [statistics.median(s), s[0], s[-1]]
                                     for o, s in zip(fns, samples)})), flush=True)


def k1a(C, others):
    """K1a of this checkout and of `others` ({name: beside namespace})."""
    import torch

    from low_precision_raytracer_tpu_torch.config import RenderConfig
    from low_precision_raytracer_tpu_torch.models.procedural import cornell_box_scene
    from low_precision_raytracer_tpu_torch.ops.dense_trace import dense_trace, dense_trace_plain
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer

    fns = {"this": dense_trace, **{o: m.dense_trace.dense_trace for o, m in others.items()}}
    for precision, cfg_kw in K1A_CASES:
        warm = Renderer(cornell_box_scene(), RenderConfig(width=C.W, height=C.H,
                                                          precision=precision, **cfg_kw))
        calls = C.capture_inputs(warm, 2)["dense_trace"]
        del warm
        for n, (args, kw, _out) in enumerate(calls):
            ref = dense_trace_plain(*args, **kw)
            for fn in fns.values():
                C.check_dense(fn(*args, **kw), ref)
            runs = [("", args, kw)]
            if precision == "bf16" and not cfg_kw:  # the closest-hit phase alone
                runs.append((" no shadow phase", args[:8],
                             {k: v for k, v in kw.items() if k == "band"}))
            for what, a, k in runs:
                samples = C.ab_ms([lambda fn=fn: fn(*a, **k) for fn in fns.values()], 20)
                report(dict(launch=f"{precision} {cfg_kw} {n}{what}"), fns, samples)
        del calls
        torch.cuda.empty_cache()


def k5(C, others):
    """K5 of this checkout and of `others` ({name: beside namespace})."""
    import torch

    from low_precision_raytracer_tpu_torch.config import RenderConfig
    from low_precision_raytracer_tpu_torch.ops import wavefront as WF
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer

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
                    fn = mod.wavefront.assigned_test
                    ko = k if "slices" in inspect.signature(fn).parameters else {}
                    fns[o] = lambda fn=fn, ko=ko: fn(*a, **ko)
                    C.k5_same(f"{name}: {o}", fns[o](), ref)
                samples = C.ab_ms(list(fns.values()), C.sample_reps(fns["this"]), rounds=9)
                report(dict(call=name, lanes=int(a[5].shape[0]), q=int(a[5].shape[1]),
                            find_any=bool(a[-1])), fns, samples)
        del calls
        torch.cuda.empty_cache()


WALK_CASES = (("cornell", "fp32", "both"), ("cornell", "fp16", "both"),
              ("cornell", "fp16", "dtype"), ("cornell", "bf16", "both"),
              ("colonnade-5k", "bf16", None), ("colonnade-8M", "bf16", None))


def walk(C, others):
    """The walk of this checkout and of `others` ({name: beside namespace})."""
    import torch

    from low_precision_raytracer_tpu_torch.config import RenderConfig
    from low_precision_raytracer_tpu_torch.models.procedural import (
        cornell_box_scene,
        sponza_like_scene,
    )
    from low_precision_raytracer_tpu_torch.ops.traversal import trace_rays, trace_rays_reference
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer

    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
    fns = {"this": trace_rays, **{o: m.traversal.trace_rays for o, m in others.items()}}
    for scene, precision, fallback in WALK_CASES:
        host = (cornell_box_scene() if scene == "cornell" else sponza_like_scene()
                if scene == "colonnade-5k" else C.colonnade_8m())
        cfg = dict(width=C.W, height=C.H, precision=precision, traversal_impl="jax")
        warm = Renderer(host, RenderConfig(**cfg, **({"triangle_fallback": fallback}
                                                     if fallback else {})))
        launches = C.capture_walk_launches(warm, 1 if scene == "cornell" else 2)
        del warm
        big = scene == "colonnade-8M"
        for n, (args, kw) in enumerate(launches):
            rkw = {k: v for k, v in kw.items() if k != "coherent"}
            ref = trace_rays_reference(*args, **rkw)
            for o, fn in fns.items():
                for x, y in zip(fn(*args, **kw), ref):
                    if not torch.equal(bits(x), bits(y)):
                        raise AssertionError(f"walk {o}: {scene} launch {n} differs from "
                                             "the reference walk")
            runs = {**fns, "reference": None}
            calls = [lambda fn=fn: fn(*args, **kw) for fn in fns.values()]
            calls.append(lambda: trace_rays_reference(*args, **rkw))
            samples = C.ab_ms(calls, 1 if big else 5, rounds=1 if big else 3)
            report(dict(launch=f"{scene} {precision} {fallback} {n}",
                        coherent=kw.get("coherent", True)), runs, samples)
        del launches
        torch.cuda.empty_cache()


def sass_loops(lib_path):
    """The innermost loops of each kernel in a built library (`cuobjdump
    -sass`): a backward branch at A to T closes the loop [T, A]; one that
    holds no other loop is innermost.  -> {kernel: [dict(start, insts,
    rcp, mma)]}, `rcp` the MUFU.RCP in the loop, `mma` its tensor-core
    instructions (HMMA / HGMMA)."""
    import os
    import re
    from pathlib import Path

    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = Path(cuda_home) / "bin" / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name = part.split()[0]
        insts = [(int(m.group(1), 16), m.group(2).strip())
                 for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)]
        loops = []
        for addr, op in insts:
            m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", op)
            if m and int(m.group(1), 16) <= addr:
                loops.append((int(m.group(1), 16), addr))
        inner = [(a, b) for a, b in loops
                 if not any((c, d) != (a, b) and a <= c and d <= b for c, d in loops)]
        out[name] = []
        for a, b in sorted(inner):
            body = [op for x, op in insts if a <= x <= b]
            out[name].append(dict(start=hex(a), insts=len(body),
                                  rcp=sum("MUFU.RCP" in op for op in body),
                                  mma=sum(bool(re.search(r"\bHG?MMA", op)) for op in body)))
    return out


def tool(C, others):
    """The Q2.4 tool's bodies of this checkout and of `others` ({name:
    beside namespace})."""
    import torch

    from low_precision_raytracer_tpu_torch.tools import mxu_proto as MP

    mods = {"this": MP, **{o: m.mxu_proto for o, m in others.items()}}
    for o, mod in mods.items():
        for kernel, loops in sass_loops(mod.cuda_lib._target("mxu_proto")).items():
            print(json.dumps(dict(sass=o, kernel=kernel, inner_loops=loops)), flush=True)
    for nchunk in (1, 8):
        case = MP.make_case(nchunk, 48, MP.R_1080P, "cuda")
        sub = C.tool_slice(case)
        for body, name in C.TOOL_NAMES.items():
            want = C.tool_plain(body, sub)
            fns = {}
            for o, mod in mods.items():
                run = getattr(mod, f"run_{body}")
                held = C.tool_hold(f"{name} {o} NCHUNK={nchunk}", body, run(sub), want)
                print(json.dumps(dict(held=o, body=body, nchunk=nchunk, hit_agreement=held[0],
                                      deviation_of_bar=held[1])), flush=True)
                fns[o] = lambda run=run: run(case)
            samples = C.ab_ms(list(fns.values()), 10)
            report(dict(body=body, tc=48, nchunk=nchunk, rays=MP.R_1080P), fns, samples)
        del case, sub
        torch.cuda.empty_cache()


# each kernel's runner, the sources built (and reported) before it (None:
# every source; colonnade-83k's frames run K1b and the schedule too) and
# the other checkouts' modules and sources (`chip_smoke.load_beside`)
KERNELS = {"k1a": (k1a, ("dense_trace",), {}), "k5": (k5, None, {}),
           "walk": (walk, ("bvh_walk",), dict(modules=("traversal",), libs=("bvh_walk",))),
           "tool": (tool, ("mxu_proto",), dict(modules=("tools/mxu_proto",),
                                              libs=("mxu_proto",)))}


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available() or len(argv) < 2 or argv[0] not in KERNELS:
        print(f"kernel_ab: needs a CUDA device, a kernel ({' | '.join(KERNELS)}) and NAME=DIR "
              "arguments", file=sys.stderr)
        return 1
    sys.path.insert(0, ".")
    import chip_smoke as C

    from low_precision_raytracer_tpu_torch.ops import cuda_lib

    run, libs, beside = KERNELS[argv[0]]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    C.ptxas_report(cuda_lib.build_all() if libs is None else cuda_lib.build_all(libs))
    others = {}
    for arg in argv[1:]:
        name, root = arg.split("=", 1)
        others[name] = C.load_beside(root, **beside)
    run(C, others)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
