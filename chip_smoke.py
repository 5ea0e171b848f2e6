"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # one card; exits non-zero without one
    python3 chip_smoke.py --profile    # also prints device time by kernel
    python3 chip_smoke.py --beside DIR # also times DIR's K5, K3, K2 and K1a (an
                                       # older checkout) on this run's inputs

Phases, in order (any failed check raises, so the exit code is non-zero):

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the port from csrc/ (one nvcc per source,
   started together), timed, with one ptxas line per kernel (registers,
   stack frame, spills; K1b's and K6's warp walk is `chunk_walk_kernel`
   (its last parameter true in K6: the zero-axis box rule), their all-row
   scans `scan_trace_kernel`, K4 `wavelet_kernel`, the schedule
   `schedule_kernel` (<true>: its counting form));
3. flagship kernel phase: two warm-up frames of the flagship (Cornell,
   bf16, 1920x1080) record the inputs each kernel wrapper gets on the main
   path; each kernel is then held against its plain PyTorch version on
   those inputs on the card (K1a, K2 and K4 bit for bit, K3 to rtol 1e-4 /
   atol 1e-5), and both are timed with CUDA events (K4 with the bytes its
   staging reads and the previous kernel's time per stride beside it; K3,
   K2 and K1a beside the older checkout's, --beside, a b b a; K1a with the
   (ray, row) pairs its culls skip and the warp steps it runs, from the
   plain emulation of its loops, `dense_trace_cull_plain`, held equal to
   the plain version; K2 with the tiles on its 16-view sum); then K4 exact
   at every stride on 97x61 and 7x29 frames with NaN, +-Inf and dead
   centres planted (`k4_edge_holds`), K3 on such frames with NaN and +-Inf
   planted, both moment branches and fc = 0 (`k3_edge_holds`), K2 bit for
   bit on synthetic 1920x1080, 97x61 and 7x29 frames (residuals in and
   outside the window, wrapping motions of both signs, NaN, +-Inf and -0
   taps in a few tiles, count 0), with both sides of its finite gate timed
   at 1080p (`k2_edge_holds`), and K1a bit for bit in every form it runs,
   packed too, on adversarial lanes (zero direction components, origins on
   a plane, mind < 0, dead lanes, coplanar ties, a doubled table:
   `k1a_edge_holds`);
4. flagship path phase: all launch counts are zeroed, a fresh Renderer
   (seed 0) renders 8 flagship frames, the counts are read; per frame the
   single-chunk trace K1a runs 2 times, the temporal kernel once, the
   a-trous kernel 5 times, and the history fetch once on the fast path
   (frame 0 has no history: like the JAX package it takes the plain 2x2
   branch there).  Every path phase of a still scene also checks that no
   per-table cache builds after frame 0, though `render()` flattens the
   scene again on every frame;
5. flagship reference phase: a 64x64 render on the card against the same
   render through the plain versions on the CPU, same uniforms, 5 frames;
5b. the command line (`cli_phase`): `cli.main(["render", "cornell", ...,
   "--frames", "8", "--profile", "--out", PNG])` at 1920x1080 bf16; the PNG
   decodes (utils/png.py) to exactly `to_uint8` of a Renderer(seed=0)'s 8th
   frame rendered in the same process; the 12 stage times (`--profile`,
   render/profile.py) on one line beside phase 4's frame ms; `parity` at
   1080p (bf16 against fp32, 8 frames, and the fp32-fallback rate);
5c. checkpoint / resume (`checkpoint_phase`): 4 flagship frames, saved; a
   fresh Renderer with another seed loads the file; frames 5-8 rendered
   both ways agree bit for bit (image and carried state);
5d. the explorer (`explorer_phase`): `serve` on 127.0.0.1 at a free port in
   a thread, 30 flagship frames at 1080p bf16, TAA 0.3, over HTTP (key and
   mouse events moving the camera, one settings round trip); frames/s and
   ms a frame beside the Renderer's own frame time in the same call (the
   viewer's host overhead);
5e. the last render options (`options_phase`): `shade_f32=False`,
   `state_f32=False`, sigma_n = 127.5 (K3's and K4's `powf` form) and
   a-trous strides to 64 on the 1080p bf16 flagship: K3 and K4 held against
   their plain versions on a warm-up frame's inputs (K4 bit for bit at
   every stride, the float exponent too; K3 at rtol 1e-4 / atol 1e-5),
   timed by stride, then 4 frames of each path (K4 once a stride).  The
   launches of phases 5b-5e join the kernels line's;
5a. the interactive path (`animated_scene`: the animated Cornell box, its
   tall box orbiting and turning and its lamp bobbing, the camera dollying
   0.02 units a frame toward the box; bf16, `taa_mix_weight=0.3`, frame f
   at time f / 30): a kernel phase on warm-up frames (8 moving, then one at
   the last time: the animation paused), each frame's history-fetch branch
   printed, every kernel held against its plain version as in phase 3 on
   the last frame whose fetch took K2 (K1a's shadow phase under the moved
   lamp, K2 bit for bit on history reprojected through the moving box and
   camera), and the plain 2x2 take timed on the last frame that took it;
   then the path phase, 8 frames: per frame K1a 2, K3 1, K4 5, and K2 once
   on a frame whose fetch took its path and never on the others (each
   frame's branch recorded; the table is rebuilt every frame, since the box
   moves); the flatten's host time per frame (every path phase prints
   it); and a 64x64 card render of the same motion against the plain
   versions on the CPU, same uniforms and TAA bits, 8 frames;
6. Sponza kernel phase: two warm-up frames of the Sponza-class frame
   (`sponza_like_scene()`, 5,314 instance triangles in 42 chunks, skybox,
   bf16, 1920x1080) record the inputs of its four multi-chunk trace (K1b)
   launches: primary, round-0 shadows, the GI bounce (sorted) and round-1
   shadows (sorted), and K3's inputs of a third frame (K3 held and timed
   on them as in phase 3).  K1b is timed on each full launch and held against
   its plain version on a fixed strided slice of 2^18 of its rays (tri,
   obj, t, u, v all exact); the sorted launches are also timed unsorted
   and with their sort + unsort, and the walk in the other persistence;
   each launch's bound counts the 32-row slices it enters (the chunk-row
   count, 128 rows a chunk entered, beside it).  Then K1b's edge holds
   (`k1b_edge_holds`, exact): the shadows' rays with a zero direction
   component, a 1,007-ray launch, whole warps of dead lanes, and the
   overflow status raised by too small a stack;
7. Sponza path phase: counts zeroed, 8 frames; per frame K1b 4, K1a 0,
   the temporal kernel 1, the a-trous kernel 5, the history fetch 1 from
   frame 1;
8. Sponza reference phase: a 64x64 Sponza render on the card against the
   plain versions on the CPU, 4 frames;
8a. Sponza-class camera path: `sponza_camera_scene` (the still scene, the
   camera turning 0.5 degrees a frame), 4 frames: K1b 4 per frame, K2 by
   branch as in 5a, and no per-table build after frame 0 (the frame's
   tables are the previous frame's tensors);
8b. textured glTF scenes (`textured_phases`; every path phase of a scene
   with textures logs its atlas size, and here each frame's texture
   fetches, `sample_texture` on both shade rounds, are timed with CUDA
   events beside the bytes a fused fetch would move): textured-box
   (tests/assets/BoxTextured.gltf, a 64x64 sRGB checker, the camera and
   lamp of tests/test_gltf.py), its load timed, 8 frames with K1a 2, K3 1,
   K4 5 and K2 from frame 1, the face centre's albedo holding both checker
   colours, a 64x64 reference with the camera on the face's axis printed
   (not held: exact hits on the face's diagonal edge) and one held with
   the camera moved by the flagship's offset, 5 frames; textured-sponza
   (the `.glb` `tools/textured_scene.py` writes: the Sponza-class geometry,
   eight 1024^2 atlas entries from seven PNGs), its write and load timed,
   K1b (2^18-ray slices), K3 and K4 held against their plain versions on
   its inputs, 8 frames with K1b 4, its albedo differing from the same
   scene's without texture ids on more than half the valid pixels, a
   64x64 reference, 4 frames, and a probe of one such frame (`fetch_probe`:
   the uv components that differ between card and CPU per shade round, and
   the fetch on the card's own inputs held within 1e-6 of the CPU's);
9. colonnade-83k kernel phase: two warm-up frames of `sponza_like_scene(8,
   3)` (82,690 instance triangles in 647 chunks, bf16, 1920x1080) record
   its two K1b launches (primary, round-0 shadows) and its two per-ray
   wavefront launches (the GI bounce, round-1 shadows).  K1b is timed on
   each full launch and held against its plain version on a strided slice
   of 2^16 rays (exact).  For each wavefront launch: the schedule kernel
   (its tree walk) equals its plain version on every ray of every call the
   launch makes, the first pass and each tail pass (words and tcut exact),
   and a 128-deep list from the first cursor on 2^18 rays; the first pass
   is timed, its plain version too, and the boxes the walk tests counted
   (the kernel's counting form) for the bound, the flat scan's count
   beside it (`schedule_holds`); K5 on every call the launch makes (the
   first pass and each tail pass) equals its plain version on every lane
   (t, row, pk exact), its counting form and the plain emulation of its
   culled loop (`assigned_cull_plain`, results and counts) on a strided
   slice, timed (beside the older checkout's, --beside) with its bound
   from the slice boxes and rows it tests (the all-row count beside it),
   the slices entered per lane under box_entry and the zero-axis rule split
   by light, and the warp divergence (`k5_holds`); K5's edge cases: the
   sun's lanes on groups they enter only under box_entry, the last partial
   chunk, any-hit rows past a chunk's first slice, keys tied across slices
   (`k5_edge_holds`); the whole launch on a slice of rays
   equals the same launch through the plain versions (tri, obj, t, u, v
   exact).  Each launch is timed whole and by part (setup, schedule, pair
   sort, K5 on all the first pass's lanes, the return and combine, each
   tail pass), and against the same rays through the anchor-sorted and
   the unsorted K1b launch;
10. colonnade-83k path phase: counts zeroed, 8 frames; per frame K1b 2, K1a
    0, the wavefront's K5 >= 2 and equal to its schedule kernel, the
    temporal kernel 1, the a-trous kernel 5, the history fetch 1 from
    frame 1;
11. colonnade-83k reference phase: a 64x64 render on the card against the
    plain versions on the CPU, 4 frames;
12. colonnade-2M kernel phase: two warm-up frames of `sponza_like_scene(10,
    5)` (2,049,202 instance triangles, 64,040 leaves, bf16, 1920x1080;
    'auto' resolves to the packet BVH) record its four packet-walk (K6)
    launches: primary, round-0 shadows, the GI bounce (sorted) and round-1
    shadows (sorted).  For each launch: the leaves entered per live ray
    (p50/p90/p99/max) under box_entry and under K6's zero-axis rule, split
    by the rays' exact zero direction components and, on the shadow
    launches, by light (`leaf_split`); K6 held equal to K1b (its chunk
    tree and slice boxes of the same table, box_entry) on every ray, both
    timed; K6 held against its plain version (K1b's, an all-pairs test)
    on 2^16 rays (a strided slice and the 4,096 rays entering the most
    leaves under box_entry) and on 1,024 face rays (one exact zero axis,
    the origin on a leaf face: `face_rays`): tri, obj, t, u, v exact on
    closest hit, the occlusion marker on any hit; the plain version timed
    on the sample; K6 timed in both persistences, its bound under its own
    rule beside box_entry's count.  The sorted launches are also timed
    unsorted, and their key and sort + unsort on their own.  In phase 9,
    K6 also runs on K1b's two colonnade-83k launches, timed and held equal
    to K1b's result;
13. colonnade-2M path phase: counts zeroed, 8 frames; per frame K6 4, K1a
    0, K1b 0, the wavefront 0, the temporal kernel 1, the a-trous kernel
    5, the history fetch 1 from frame 1;
14. packet-route reference phase: a 64x64 render of colonnade-5k
    (`sponza_like_scene()`) with traversal_impl='pallas' (K6 on all four
    launches, the last two sorted) on the card against the plain versions
    on the CPU, 4 frames.  At 2M rows the CPU plain path (an all-pairs
    test) would take hours, so the reference runs on the smaller scene;
14a. the two-level BVH walk (`traversal_impl='jax'`, csrc/bvh_walk.cu):
    colonnade-2M on the walk, 3 frames (per frame the walk 3: the
    primary, round 0's shadows and GI bounce as one closest-hit launch,
    round 1's shadows; K3 1, K4 5, K2 from frame 1), its frame ms printed
    beside K6's; the walk kernel phase (`walk_kernel_phase`): colonnade-8M
    (`sponza_like_scene(10, 6)`, 8,193,202 instance triangles in 201
    objects: no coefficient table, 'auto' resolves to the walk), the
    Renderer's host build timed (the BLAS by the native builder, the
    first TLAS), two warm-up frames record its three walk launches; on
    each the walk (`trace_rays`: the short stack, dead rays unwalked, on
    incoherent launches the live rays packed, the exact zero-axis rule on
    BLAS boxes) and its reference, the walk's first form
    (`trace_rays_reference`, on no render path), are timed in turns (on
    incoherent launches the walk in place, the walk on rays sorted by
    `morton_key` and the packing's `launch_order` too), each with its
    per-ray counts (steps, triangle tests, objects
    entered: p50/p90/p99/max steps per live ray, the warps' efficiency on
    its launched order, the bound from them; the walk's dead rays count
    0), and the walk is held bit for bit (t, u, v, ids) against the
    reference on every ray; the reference (t, u, v, ids, counts) and the
    walk (t, u, v, ids) are held bit for bit against the plain version on
    2,048 rays of each kind (primary, round-0 shadows, GI bounce, round-1
    shadows) among those its counts take at most WALK_CAP steps, the share
    under the cap printed; then colonnade-5k (`sponza_like_scene()`) under
    'jax', each kind held on 2^16 rays with no step cap, its 4,096 longest
    walks and its 4,096 longest zero-axis walks (the sun's rays, ~1,500
    steps) among them, the largest held step count printed beside the
    kind's (and required equal to it), and Cornell under 'jax' in
    bf16, fp16 and fp32, 'both' and 'dtype', each launch held on 2^16
    rays: there both the reference and the walk against the plain
    version, and the walk against the reference on every ray; colonnade-2M
    under 'jax' (two frames' launches): the walk against the reference on
    every ray, both timed; the colonnade-8M
    path phase, 8 frames (the walk 3 a frame); a 64x64 card render of
    colonnade-830 (`sponza_like_scene(3, 1)`) under 'jax' against the CPU,
    2 frames; one flagship frame on the all-pairs route
    (`traversal_impl='dense'`, plain PyTorch);
15. fp32 flagship kernel phase: K1a with the f32 'both' band (and its
    fused shadow phase) on the two 1080p launches of the fp32 flagship,
    held against its plain version on every ray (t, u, v, tri, obj, vis
    exact; the bf16 launches of phase 3 are held the same way) and timed;
16. fp32 flagship path phase: 8 frames; per frame K1a 2, K1b 0, K6 0, the
    wavefront 0, the temporal kernel 1, the a-trous kernel 5, the history
    fetch 1 from frame 1.  Then the parity line: PSNR and SSIM
    (`utils/image.py`) between the 8th frame of this run and of phase 4's
    bf16 run, same seed; and a 64x64 fp32 render on the card against the
    plain versions on the CPU, 5 frames;
17. fp32 Sponza-class: K1b with the f32 band on the four 1080p launches,
    exact against the plain version on 2^18-ray slices (the plain version
    timed on the slice), then 8 frames with K1b 4 per frame;
18. fp32 packet route: the Sponza-class frame with traversal_impl='pallas':
    K6 with its own f32 band on the four launches, exact against the plain
    version on 2^12-ray slices, timed; then 4 frames with K6 4 per frame;
19. colonnade-328k kernel phase: `sponza_like_scene(8, 4)` (328,450
    instance triangles in 2,567 chunks, bf16, 1920x1080; 'auto' resolves
    to the dense route): K1b (its walk of a tree over the chunk boxes) on
    the primary and round-0 shadow launches, exact against the plain
    version on a 2^16-ray slice (primary) and a 2^20-ray slice (the round-0
    shadows, the plain version in slabs of 2^26 (ray, row) pairs), timed
    with its bound; the schedule kernel on its two wavefront launches, as
    in phase 9 (`schedule_holds`), and K5 (two chunks a group) on every
    call they make with its edge cases (`k5_holds`, `k5_edge_holds`);
20. colonnade-328k path phase: 8 frames; per frame K1b 2, the wavefront's
    K5 >= 2 and equal to its schedule kernel, K6 0, K1a 0.

fp16 ('mxu3', the kernel routes 'auto' takes) runs between phases 16 and
17:

16a. fp16 flagship kernel phase: K1a (fused shadow phase) on the two 1080p
     launches of the fp16 flagship's second frame, exact against its plain
     version on every ray, timed;
16b. fp16 flagship path phase: 8 frames, per frame K1a 2, K1b 0, K6 0, the
     wavefront 0, K3 1, K4 5, K2 1 from frame 1; then the fp16-vs-fp32
     parity line (PSNR, SSIM of the 8th frames, same seed) beside the bf16
     one; a 64x64 fp16 render on the card against the CPU plain path, 5
     frames;

and after phase 20:

21. fp16 colonnade-83k: K5 on every call of its two wavefront launches
    (`k5_holds`), then the path phase: 4 frames, K1b 2 and the wavefront
    per frame as in bf16;
22. band kernel phases, for 'both' and 'dtype' in bf16 and in fp16, and
    for fp32 'dtype' (`band_kernel_phase`): K1a on the flagship's two launches (every ray),
    K1b on the Sponza-class frame's four (2^18-ray slices) and K6 on its
    packet route's four (colonnade-5k with traversal_impl='pallas',
    4,096-ray slices), each exact against its plain version, timed, with
    its bound, from one warm-up frame each.  K1b and K6 walk their trees
    growing each box for the ray that tests it by the band's reach
    (`ops/band_pad.py`): each walk is also held bit for bit against the
    all-row scan kernel (`band_scan`) on every ray, both timed, and its
    bound counts the grown boxes it enters (at each ray's final best t in
    closest hit), beside the unpadded boxes' count and the scan's (an
    any-hit launch's scan count takes each blocked ray's rows up to its
    first accepted row); the slices (K1b) or leaves (K6) entered per live
    ray under the grown and the unpadded boxes;
23. band path phases, 4 frames each: the Sponza-class frame in fp16 'both'
    (K1b 4 per frame), the flagship in bf16 'dtype' (K1a 2), the packet
    route on colonnade-5k in fp16 'both' (K6 4); then the fp32-fallback
    rate of Cornell's primary launch at 256x256 in fp16 and bf16;
23a. the bands above the old 8,192-triangle cap (`band_big_kernel_phase`):
    colonnade-83k in bf16 'both' and fp16 'dtype' (the dense route, K1b
    four times a frame, two sorted) and colonnade-2M in bf16 'both' (the
    packet route, K6): each launch of one warm-up frame held bit for bit
    against the scan kernel (every ray on colonnade-83k, a strided 2^16-ray
    slice on colonnade-2M), both timed, with the slices or leaves entered
    per live ray; then 3 frames of each path (no band_scan launch on any
    path phase: the counts hold it at 0);
24. the packed epilogue (bf16, `dense_epilogue='pack'`, `pack_phases`):
    K1a's packed form on the flagship's two closest-hit launches (every
    ray: t, row, pk exact) and K1b's on the Sponza-class frame's two
    (primary, sorted GI bounce; 2^18-ray slices), each timed beside the
    full epilogue on the same rays; 4 frames of each path, the launch
    sequence held (flagship: K1a packed 2, K1b any hit 1, no fused shadow
    phase; Sponza-class: K1b packed 2, K1b any hit 2);
25. the wavefront's 'rounds' mode on colonnade-83k (`rounds_kernel_phase`):
    each K5 launch of its two 1080p wavefront launches (q = 4 lanes, and
    the tail passes' q = 1) through `k5_holds` (every lane exact, timed
    with its bound); each launch on a slice of rays exact against its
    plain route; rounds, cycles and tail rays; the launch timed against
    'oneshot' on the same rays; 4 frames (the schedule >= 2 and K5 at
    least as often per frame); a 64x64 'rounds' render on the card against
    the CPU plain path, 2 frames;
26. the Q2.4 tool (`tools/mxu_proto.py`, `tool_phase`) at TC = 48 on
    2,073,600 rays, NCHUNK = 1 and 8: its own run with the counts zeroed
    (both bodies timed, their agreement), then the VPU body exact and the
    tensor-core body within its bar (hit agreement >= 0.9999, |x - plain|
    <= 1e-5 |plain| + 1e-6) against their plain versions on 2^16-ray
    slices, with their bounds.

Before the last line it prints a `kernels_fp32` JSON line (K1a, K1b, K6 in
fp32: launches on the fp32 path phases, the fp32 kernel phases' times), a
`kernels_fp16` line (K1a in fp16, launches on the fp16 'mxu3' path
phases), a `kernels_band` line (per acceptance, K1a, K1b and K6: times of
that acceptance's kernel phase, the scan kernel's beside K1b's and K6's
(`scan_ms`), launches over the band path phases of that acceptance, null
where none ran it), a `kernels` JSON line (per kernel: launches over every path
phase, max error against the plain version, time, plain time, the least
time the work could take on the card and what bounds it; K1b's times are
those of its bf16 Sponza-class launches, its colonnade-83k and -328k
launches are on their own lines; K6's are the mean of its four
colonnade-2M launches, the walk's and its reference's (`bvh_walk_ref`, on
no path: 0 launches) of its three colonnade-8M launches) and
the nvidia-smi line; the last line is
{"ok": true, "device": {...}}.  The `kernels` line also has K1a's and
K1b's packed forms (their times from phase 24) and the tool's two bodies
(NCHUNK = 1; launches from phase 26).  Frame times, and K1b's, K4's,
K6's and the schedule's times per launch, print beside the previous
tree's (`PREV_*`).  About 11 minutes on an H100, most of it the plain
versions' holds of phases 12, 14a and 19, cut to fit the new phases:
colonnade-2M's K6 hold 2^16 -> 2^14 rays a launch (HUGE_CHECK), BIG_CHECK
2^16 -> 2^14, colonnade-328k's round-0 shadow hold 2^20 -> 2^18 rays,
colonnade-8M's walk slices 2,048 -> 1,024 rays (WALK_CHECK) and the
Cornell / colonnade-5k walk slices 2^16 -> 2^15 (WALK_CHECK_SMALL).  The
`kernels` line's K3 and K4 carry their float-exponent times
(`ms_sigma_n_float`) and K4 its times at strides up to 64
(`ms_by_stride_wide`).
"""

from __future__ import annotations

import inspect
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

W, H = 1920, 1080
PATH_FRAMES = 8
REF_SIZE, REF_FRAMES = 64, 5
SPONZA_REF_FRAMES = 4
FPS = 30  # the moving path phases: frame f renders at time f / FPS (as tools/frame_times.py)
YAW_DEG = 0.5  # the Sponza-class camera phase: degrees a frame
CAMERA_FRAMES = 4
BIG_BAND_FRAMES = 3  # frames of the band path phases above the old 8,192-triangle cap
CHECK_RAYS = 1 << 18  # K1b: rays per launch held against the plain version
BIG_CHECK = 1 << 14  # colonnade-83k / -328k: rays or lanes held against the plain versions
HUGE_CHECK = 1 << 14  # colonnade-2M: rays per K6 launch held against the plain version
PACKET_CHECK = 1 << 12  # the fp32 packet route (Sponza-class): rays per K6 launch held
SHADOW_328K_CHECK = 1 << 18  # colonnade-328k's round-0 shadows: rays held
WALK_2M_FRAMES = 3  # colonnade-2M on the BVH walk
WALK_REF_FRAMES = 2  # the walk route's 64x64 reference
# H100 SXM datasheet peaks: HBM bytes/s, f32 FLOP/s
# outside the tensor cores (exp/sqrt/div counted as one operation each)
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12  # dense bf16 on the tensor cores
# Older trees' figures from PERF.md's chip runs on an NVIDIA H100 80GB HBM3
# at 700 W, printed beside this run's: frame ms of the path phases (the
# tree before the per-frame flatten; Sponza fp32 and colonnade-83k fp16
# older), ms per launch of K4 by stride, of K1b, K6 and the schedule by
# (scene, launch).
# K5 and K3 are compared with an older checkout's on this run's own inputs
# instead (`--beside DIR`, `load_beside`).
PREV_FRAME_MS = {"flagship": 37.149, "sponza": 111.794, "colonnade-83k": 69.548,
                 "colonnade-328k": 85.421, "colonnade-2M": 59.194, "flagship-fp32": 38.674,
                 "flagship-fp16": 36.288, "sponza-fp32": 116.840, "colonnade-83k-fp16": 76.070}
PREV_K4_MS = {1: 0.299, 2: 0.299, 4: 0.307, 8: 0.308, 16: 0.337}
PREV_LAUNCH_MS = {
    ("sponza", "primary"): 1.381, ("sponza", "shadow0"): 2.430,
    ("sponza", "gi_sorted"): 1.208, ("sponza", "shadow1_sorted"): 1.115,
    ("colonnade-83k", "primary"): 1.744, ("colonnade-83k", "shadow0"): 8.481,
    ("colonnade-328k", "primary"): 1.959, ("colonnade-328k", "shadow0"): 15.479,
    ("sponza pack", "primary"): 1.233, ("sponza pack", "gi_sorted"): 1.166,
    ("colonnade-2M", "primary"): 2.535, ("colonnade-2M", "shadow0"): 3.989,
    ("colonnade-2M", "gi_sorted"): 4.862, ("colonnade-2M", "shadow1_sorted"): 2.797,
    ("colonnade-83k schedule", "gi"): 0.809, ("colonnade-83k schedule", "shadow1"): 1.940}
# ... and the means kept there where no launch's own was kept
PREV_MEAN_MS = {"sponza-fp32": 2.220, "sponza-fp32 packet route": 1.534}
BESIDE = None  # an older checkout's K5, K3, K2 and K1a wrappers (--beside DIR), or None
TPU = "low_precision_raytracer_tpu/ops/"
KERNELS = {  # wrapper name -> (source, TPU kernel it replaces)
    "dense_trace": ("low_precision_raytracer_tpu_torch/csrc/dense_trace.cu",
                    TPU + "dense_pallas.py:183"),
    "dense_trace_multi": ("low_precision_raytracer_tpu_torch/csrc/dense_multi.cu",
                          TPU + "dense_pallas.py:526"),
    "coef_fetch": ("low_precision_raytracer_tpu_torch/csrc/svgf.cu",
                   TPU + "svgf_pallas.py:762"),
    "temporal_accum": ("low_precision_raytracer_tpu_torch/csrc/svgf.cu",
                       TPU + "svgf_pallas.py:920"),
    "wavelet_iter": ("low_precision_raytracer_tpu_torch/csrc/svgf.cu",
                     TPU + "svgf_pallas.py:79"),
    "wavefront_assigned": ("low_precision_raytracer_tpu_torch/csrc/wavefront.cu",
                           TPU + "wavefront.py:99"),
    # XLA code in the JAX package (`_schedule`), not a Pallas kernel
    "wavefront_schedule": ("low_precision_raytracer_tpu_torch/csrc/wavefront.cu",
                           TPU + "wavefront.py:211"),
    "packet_trace": ("low_precision_raytracer_tpu_torch/csrc/packet_trace.cu",
                     TPU + "traversal_pallas.py:69"),
    # the packed winner epilogue of K1a and K1b (dense_epilogue='pack')
    "dense_trace_pack": ("low_precision_raytracer_tpu_torch/csrc/dense_trace.cu",
                         TPU + "dense_pallas.py:130"),
    "dense_trace_multi_pack": ("low_precision_raytracer_tpu_torch/csrc/dense_multi.cu",
                               TPU + "dense_pallas.py:130"),
    # the JAX package's XLA walk (`trace_rays`), not a Pallas kernel
    "bvh_walk": ("low_precision_raytracer_tpu_torch/csrc/bvh_walk.cu",
                 TPU + "traversal.py:79"),
    # its first form, the walk's reference on the card: on no path
    "bvh_walk_ref": ("low_precision_raytracer_tpu_torch/csrc/bvh_walk.cu",
                     TPU + "traversal.py:79"),
    # the Q2.4 measurement tool's two bodies
    "mxu_proto_vpu": ("low_precision_raytracer_tpu_torch/csrc/mxu_proto.cu",
                      "tools/bench_mxu_proto.py:31"),
    "mxu_proto_mxu": ("low_precision_raytracer_tpu_torch/csrc/mxu_proto.cu",
                      "tools/bench_mxu_proto.py:103"),
}


# kernels of the kernels line that no render path runs (a reference)
OFF_PATH = ("bvh_walk_ref",)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps):
    """Mean ms per call of fn over `reps` calls, CUDA events, after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sample_reps(fn, target_ms=2.0, most=200):
    """Calls of fn a timing sample needs to last about `target_ms`."""
    return min(most, max(3, math.ceil(target_ms / max(cuda_ms(fn, 3), 1e-3))))


def ab_ms(fns, reps, rounds=5):
    """ms per call of each of `fns` (`cuda_ms` over `reps` calls a sample),
    sampled in `rounds` rounds, each in the order fns and then reversed (a
    b b a for two), so that a drift of the card's clock falls on each
    alike.  -> per fn its samples, sorted."""
    samples = [[] for _ in fns]
    order = list(range(len(fns)))
    for _ in range(rounds):
        for i in order + order[::-1]:
            samples[i].append(cuda_ms(fns[i], reps))
    return [sorted(x) for x in samples]


def bound_ms(n_bytes, n_ops):
    t_bytes, t_ops = n_bytes / HBM_BPS, n_ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def load_beside(root, modules=("wavefront", "svgf_kernels", "dense_trace"),
                libs=("wavefront", "svgf", "dense_trace")):
    """The K5, K3, K2 and K1a wrappers (`modules` of ops/, built from
    `libs`) of an older checkout of this repository at `root` (`git
    archive` of another commit), bound to that checkout's own kernels (its
    csrc/, built into its own _build/), for timing beside this tree's
    kernels on the same inputs.  Each wrapper module is loaded with the
    older `ops/cuda_lib.py` standing in for this tree's while it is
    imported; its other imports are this tree's.  -> namespace(wavefront,
    svgf_kernels, dense_trace), one attribute a module."""
    import importlib.util
    import types
    from pathlib import Path

    import low_precision_raytracer_tpu_torch.ops as ops_pkg
    # this tree's modules first, so that everything the older modules import
    # from this tree is bound to this tree's cuda_lib
    import low_precision_raytracer_tpu_torch.ops.svgf_kernels  # noqa: F401
    import low_precision_raytracer_tpu_torch.ops.trace  # noqa: F401

    pkg = Path(root).resolve() / "low_precision_raytracer_tpu_torch"

    def load(name, path):
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    key = "low_precision_raytracer_tpu_torch.ops.cuda_lib"
    own = sys.modules[key]
    lib = load("beside_cuda_lib", pkg / "ops" / "cuda_lib.py")
    sys.modules[key] = ops_pkg.cuda_lib = lib
    try:
        mods = {m: load(f"beside_{m}", pkg / "ops" / f"{m}.py") for m in modules}
    finally:
        sys.modules[key] = ops_pkg.cuda_lib = own
    t0 = time.perf_counter()
    lib.build_all(libs)
    log(f"beside {root}: {', '.join(libs)} built in {time.perf_counter() - t0:.2f} s")
    return types.SimpleNamespace(**mods)


# ---------------------------------------------------------------------------
# operation counts (f32 arithmetic, from the kernels' code)

TRI_TEST_OPS = 40  # 6 dot rows (28) + t = -Oz/Dz (2) + u, v (4) + u+v (1) + 5 compares
# the f32 'both' band on top, per (ray, row): the four S rows (22), the two
# error bounds (16), w and the sum of the bounds (3), the three band tests
# (11), the widened test (7), the select (2); the kernels also scale |n|, |e|
# per row (16 more), work the JAX package does once per table, not counted
BAND_OPS = 61
# a sub-f32 form on top of that: its dtype rows Ox, Oy (12) and Dx, Dy (10)
# from the band rows and the rounded ray, and t Dx, t Dy, u, v on them (4);
# the f32 rows' u32, v32 are the strict test's u, v (counted above); the
# ray's rounding is per ray (6), not counted per row
SUB_BAND_OPS = 26
SHADOW_SETUP_OPS = 14  # to-light vector 3, length 6, 1/max 2, direction 3
# slab test per tree box: 6 subtracts, 6 multiplies, 6 min/max, 6
# finiteness tests, 4 running min/max, entry 2, acceptance 4
BOX_TEST_OPS = 34


def row_ops(band):
    if band is None or not band.form:
        return TRI_TEST_OPS
    return TRI_TEST_OPS + BAND_OPS + (SUB_BAND_OPS if band.operand is not None else 0)


# K1a's culls (csrc/dense_trace.cu:cull): a visited (ray, row) pair costs
# its plane rows Oz, Dz (3 multiplies and 3 adds, 3 and 2), part of the
# row test, and the cull (the product rounded up, the range and the sign
# compares); a pair that survives the rest of the row test
PLANE_OPS = 11
CULL_OPS = 3


def dense_trace_ops(args, kw, out, culls=None):
    """Triangle tests this run's data needs.  With `culls` (`k1a_culls`:
    the (ray, row) pairs K1a's culled loops visit and test in full, per
    phase): PLANE_OPS + CULL_OPS per visited pair and the rest of the row
    test per pair tested in full.  Without (the all-row count): every live
    lane against every row, then per winner and light the rows up to the
    first occluder (the any-hit loop stops there).  Either way the shadow
    rays' setup per winner and light."""
    import torch

    from low_precision_raytracer_tpu_torch.ops.dense_trace import STRICT, tri_quantities

    o, d, skip, mind, maxd, coef, tri_ids = args[:7]
    lights = None if kw.get("pack") else (args[8] if len(args) > 8 else kw.get("lights"))
    d_mov = kw.get("d_mov", 0.0)
    band = kw.get("band", STRICT)
    n_lights = 0 if lights is None else lights.shape[0]
    setup = 0 if lights is None else int((out[3] >= 0).sum()) * n_lights * SHADOW_SETUP_OPS
    if culls is not None:
        return setup + sum(c["tests"] * (PLANE_OPS + CULL_OPS)
                           + c["full"] * (row_ops(band) - PLANE_OPS) for c in culls.values())
    TI = coef.shape[0]
    tests = int((maxd > mind).sum()) * TI
    if lights is None:
        return tests * row_ops(band)
    t, tri = out[0], out[3]
    got = tri >= 0
    p = (o + t[:, None] * d)[got]
    wtri = tri[got]
    for l in range(n_lights):
        a = lights[l, 1:4]
        dvec = a[None, :] - p
        dist = torch.sqrt(dvec[:, 0] * dvec[:, 0] + dvec[:, 1] * dvec[:, 1]
                          + dvec[:, 2] * dvec[:, 2])
        isdir = lights[l, 0] > 0
        inv = 1.0 / dist.clamp(min=1e-20)
        sdir = torch.where(isdir, a[None, :].expand_as(dvec), dvec * inv[:, None])
        maxd_l = torch.where(isdir, torch.full_like(dist, 1000.0), dist)
        t2, _, _, geom = tri_quantities(coef, p, sdir, band)
        blk = geom & (t2 > d_mov) & (t2 < maxd_l[:, None]) & (tri_ids[None] != wtri[:, None]) \
            & torch.isfinite(t2)
        first = torch.where(blk.any(1), blk.to(torch.int8).argmax(1) + 1, TI)
        tests += int(first.sum())
    return tests * row_ops(band) + setup


def coef_fetch_ops(C, HW):
    # per view: coefficient terms (compare-select each, adds between) and
    # C multiply-adds; then the weight sum and C divides
    terms = 0
    for vx in range(-1, 3):
        for vy in range(-1, 3):
            n = sum(1 for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1))
                    if -1 <= vy - dy <= 1 and -1 <= vx - dx <= 1)
            terms += n + (n - 1) + 2 * C
    return (terms + 3 + C) * HW


def temporal_ops(HW):
    # stage 1 per instance-channel: 3 box sums of 16 adds + 3 operands, 2
    # divides, var/sqrt 3, clamp 6, lerp 3, luminance 2 = 67 (x 6)
    # moments per tap: dd 3, t1 3, n.n' 5, max 1, pow128 7, weight 3, two
    # instances x 7 = 36 (x 25); write-out ~20
    return (6 * 67 + 25 * 36 + 20) * HW


def wavelet_ops(HW):
    # prefilter 9 taps x 6, reciprocals 10; per tap: geometry 20, two
    # instances x 18 = 56 (x 25); write-out 10
    return (54 + 10 + 25 * 56 + 10) * HW


# ---------------------------------------------------------------------------


def capture_inputs(renderer, frames, times=None):
    """Render `frames` frames (frame i at `times[i]`, else at time 0) and
    return the wrapper calls of the last one: {name: [(args, kwargs,
    output), ...]}, recorded at the call sites."""
    from low_precision_raytracer_tpu_torch.ops import reproject, svgf_kernels, trace

    sites = [(trace, "dense_trace"), (reproject, "coef_fetch"),
             (svgf_kernels, "temporal_accum"), (svgf_kernels, "wavelet_iter")]
    calls = {}
    originals = []

    def recorder(name, fn):
        def rec(*args, **kw):
            out = fn(*args, **kw)
            calls.setdefault(name, []).append((args, kw, out))
            return out
        return rec

    try:
        for mod, name in sites:
            originals.append((mod, name, getattr(mod, name)))
            setattr(mod, name, recorder(name, getattr(mod, name)))
        for f in range(frames):
            calls.clear()
            renderer.render(time=times[f] if times else 0.0)
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    return calls


def check_svgf(name, k, p):
    """NaN positions identical, rtol 1e-4 / atol 1e-5 elsewhere.  -> max
    abs error."""
    import torch

    k, p = (torch.cat([t.reshape(-1) for t in x]) if isinstance(x, tuple) else x
            for x in (k, p))
    if not torch.equal(torch.isnan(k), torch.isnan(p)):
        raise AssertionError(f"{name}: NaN positions differ")
    ok = ~torch.isnan(k)
    if not torch.allclose(k[ok], p[ok], rtol=1e-4, atol=1e-5):
        raise AssertionError(f"{name}: kernel and plain version disagree "
                             f"(max abs err {(k[ok] - p[ok]).abs().max().item()})")
    return float((k[ok] - p[ok]).abs().max())


def check_bits(name, k, p):
    """Bit for bit: NaN at the same places, every other value's bits
    equal.  -> max abs error (0)."""
    import torch

    nan_k, nan_p = torch.isnan(k), torch.isnan(p)
    if not torch.equal(nan_k, nan_p):
        raise AssertionError(f"{name}: NaN positions differ on "
                             f"{int((nan_k != nan_p).sum())} of {k.numel()} values")
    diff = (k.view(torch.int32) != p.view(torch.int32)) & ~nan_k
    if bool(diff.any()):
        raise AssertionError(f"{name}: {int(diff.sum())} of {k.numel()} values differ from the "
                             f"plain version (max abs err {float((k - p).abs()[diff].max())})")
    return 0.0


def ptxas_report(logs):
    """One line per kernel of nvcc's -Xptxas -v output: its (demangled)
    name, registers, stack frame and spills."""
    import re
    import shutil

    filt = shutil.which("c++filt")
    for lib, text in logs.items():
        name, props = None, ""
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                name = m.group(1)
                if filt:
                    name = subprocess.run([filt, name], capture_output=True, text=True,
                                          timeout=30).stdout.strip() or name
                name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
                name = name.split("(")[0]  # the argument list
                continue
            if "stack frame" in line:
                props = line.strip()
            elif "registers" in line:
                log(f"ptxas {lib} {name}: {line.split(':', 1)[-1].strip()}; {props}")
                props = ""


def k4_edge_holds():
    """K4 held bit for bit against its plain version at every stride of
    the pipeline on odd frame sizes: 97 x 61 and 7 x 29 (narrower than 2s
    from s = 4 on), the planes made from a seed with NaN, +-Inf and dead
    centres (pen > 0) planted."""
    import torch

    from low_precision_raytracer_tpu_torch.config import SVGFConfig
    from low_precision_raytracer_tpu_torch.ops.svgf_kernels import (
        C_PEN0,
        N_CV,
        N_GEO,
        wavelet_iter,
        wavelet_iter_plain,
    )

    cfg = SVGFConfig()
    gen = torch.Generator(device="cuda").manual_seed(7)
    rand = lambda *shape: torch.rand(shape, device="cuda", generator=gen)
    for Hs, Ws in ((61, 97), (29, 7)):
        yy = torch.arange(Hs, device="cuda")[:, None].float()
        xx = torch.arange(Ws, device="cuda")[None, :].float()
        geo = torch.zeros((N_GEO, Hs, Ws), device="cuda")
        geo[0] = 2 + 0.3 * torch.sin(xx / 7) + 0.2 * torch.cos(yy / 5)
        geo[1:3] = 0.05 * (rand(2, Hs, Ws) - 0.5)
        n = torch.stack([0.2 * torch.sin(xx / 9).expand(Hs, Ws),
                         0.2 * torch.cos(yy / 8).expand(Hs, Ws), torch.ones(Hs, Ws, device="cuda")])
        geo[3:6] = n / n.norm(dim=0, keepdim=True)
        geo[6] = 1.0
        geo[7:9] = rand(2, Hs, Ws)
        geo[C_PEN0:C_PEN0 + 2] = torch.where(rand(2, Hs, Ws) < 0.05, 1e30, 0.0)
        cv = rand(N_CV, Hs, Ws)
        for b in (0, 6):
            cv[b + 4] = (rand(Hs, Ws) < 0.85).float()
            cv[b + 5] = (rand(Hs, Ws) < 0.85).float()
        m = rand(N_CV, Hs, Ws)
        cv = torch.where(m < 0.02, float("nan"), cv)
        cv = torch.where((m > 0.5) & (m < 0.52), float("inf"), cv)
        cv = torch.where((m > 0.7) & (m < 0.72), -float("inf"), cv)
        g = rand(3, Hs, Ws)
        geo[0] = torch.where(g[0] < 0.02, float("nan"), geo[0])
        geo[7] = torch.where(g[1] < 0.02, float("inf"), geo[7])
        geo[1] = torch.where(g[2] < 0.01, float("nan"), geo[1])
        geo, cv = geo.contiguous(), cv.contiguous()
        for stride in cfg.strides:
            out = wavelet_iter(geo, cv, stride, cfg)
            torch.cuda.synchronize()
            check_bits(f"wavelet_iter {Ws}x{Hs} stride {stride}", out,
                       wavelet_iter_plain(geo, cv, stride, cfg))
        log(f"kernel wavelet_iter edge hold {Ws}x{Hs}: strides {list(cfg.strides)} equal "
            "(NaN, +-Inf and dead centres planted)")


def k3_edge_holds():
    """K3 held against its plain version (rtol 1e-4 / atol 1e-5, NaN
    positions equal) on odd frame sizes, 97 x 61 and 7 x 29 (narrower than
    a tile, rows not 16-byte aligned), the planes made from a seed with
    NaN, +-Inf and out-of-range depths planted in colour, geometry and
    history; the history count fc is 0 on some pixels, below the spatial
    moments threshold on others and above it on the rest (both moment
    branches)."""
    import torch

    from low_precision_raytracer_tpu_torch.config import SVGFConfig
    from low_precision_raytracer_tpu_torch.ops.svgf_kernels import (
        BIG,
        N_CTR,
        T_FC,
        temporal_accum,
        temporal_accum_plain,
    )

    cfg = SVGFConfig()
    gen = torch.Generator(device="cuda").manual_seed(11)
    rand = lambda *shape: torch.rand(shape, device="cuda", generator=gen)
    for Hs, Ws in ((61, 97), (29, 7)):
        yy = torch.arange(Hs, device="cuda")[:, None].float()
        xx = torch.arange(Ws, device="cuda")[None, :].float()
        geo = torch.zeros((7, Hs, Ws), device="cuda")
        geo[0] = 2 + 0.3 * torch.sin(xx / 7) + 0.2 * torch.cos(yy / 5)
        geo[0] = torch.where(rand(Hs, Ws) < 0.05, BIG, geo[0])  # sky
        geo[1:3] = 0.05 * (rand(2, Hs, Ws) - 0.5)
        n = torch.stack([0.2 * torch.sin(xx / 9).expand(Hs, Ws),
                         0.2 * torch.cos(yy / 8).expand(Hs, Ws), torch.ones(Hs, Ws, device="cuda")])
        geo[3:6] = n / n.norm(dim=0, keepdim=True)
        geo[3:6] = torch.where(rand(Hs, Ws) < 0.03, 0.0, geo[3:6])  # no normal
        geo[6] = 1.0
        col = 2 * rand(6, Hs, Ws)
        ctr = rand(N_CTR, Hs, Ws)
        u = rand(Hs, Ws)  # fc: 0, below the threshold, above it
        below = float(cfg.spatial_moments_below)
        ctr[T_FC] = torch.where(u < 0.2, 0.0, torch.where(u < 0.6, torch.floor(below * rand(Hs, Ws)),
                                                          below + torch.floor(8 * rand(Hs, Ws))))
        for x, share in ((col, 1.0), (ctr, 1.0), (geo, 0.3)):
            m = rand(*x.shape)
            x.copy_(torch.where(m < 0.02 * share, float("nan"), x))
            x.copy_(torch.where((m > 0.5) & (m < 0.5 + 0.02 * share), float("inf"), x))
            x.copy_(torch.where((m > 0.7) & (m < 0.7 + 0.02 * share), -float("inf"), x))
        col, geo, ctr = col.contiguous(), geo.contiguous(), ctr.contiguous()
        for color_w, moments_w in ((0.2, 0.2), (1.0, 1.0)):
            out = temporal_accum(col, geo, ctr, cfg, color_w, moments_w)
            torch.cuda.synchronize()
            err = check_svgf(f"temporal_accum {Ws}x{Hs}", out,
                             temporal_accum_plain(col, geo, ctr, cfg, color_w, moments_w))
            spatial = int((ctr[T_FC] < below).sum())
            log(f"kernel temporal_accum edge hold {Ws}x{Hs} (color_w {color_w}, moments_w "
                f"{moments_w}): within rtol 1e-4 / atol 1e-5, max abs err {err}; fc = 0 on "
                f"{int((ctr[T_FC] == 0).sum())}, spatial moments on {spatial} of {Hs * Ws} "
                "pixels (NaN, +-Inf planted)")


def k2_edge_holds():
    """K2 held bit for bit against its plain version on synthetic inputs
    (made from a seed): frames of 1920x1080, 97x61 and 7x29; residuals
    drawn from {-1, 0, 1} (some -0) with 3% outside the window (+-2, 0.5,
    NaN); weights with -0, NaN and +Inf among them; count 0 on a third of
    the pixels; global motions (0, 0), (3, -5), (-2, 7) and one past the
    frame's size (wrapping), each with NaN, +-Inf and -0 history taps
    planted in a few tiles only; all with the main path's 10 history
    channels (`coef_fetch_kernel<10>`), and the small frames and a 1080p
    frame also with 1, 3 and 16 (the run-time-C body).  Then the finite gate's two sides timed
    at 1920x1080: every tile finite (the matched views) and one NaN
    planted per tile (the 16-view sum everywhere), beside the plain
    version's time."""
    import torch

    from low_precision_raytracer_tpu_torch.ops.svgf_kernels import (
        FETCH_TILE,
        coef_fetch,
        coef_fetch_plain,
        fetch_full_tiles,
    )

    gen = torch.Generator(device="cuda").manual_seed(13)
    rand = lambda *shape: torch.rand(shape, device="cuda", generator=gen)

    def inputs(Hs, Ws, planted=True, C=10):
        hist = 4 * rand(C, Hs, Ws) - 2
        hist = torch.where(rand(C, Hs, Ws) < 0.05, -0.0, hist)
        if planted:  # a few taps in a few places: most tiles stay finite
            for val in (float("nan"), float("inf"), -float("inf")):
                for _ in range(2):
                    c, y, x = (int(torch.randint(0, n, (1,), device="cuda", generator=gen))
                               for n in (C, Hs, Ws))
                    hist[c, y, x] = val
        res = torch.floor(3 * rand(2, Hs, Ws)) - 1
        res = torch.where(rand(2, Hs, Ws) < 0.05, -0.0 * torch.ones_like(res), res)
        odd = torch.tensor([-2.0, 2.0, 0.5, float("nan")], device="cuda")
        pick = odd[torch.randint(0, 4, (2, Hs, Ws), device="cuda", generator=gen)]
        res = torch.where(rand(2, Hs, Ws) < 0.03, pick, res)
        w = rand(4, Hs, Ws) * (rand(4, Hs, Ws) > 0.2)
        w = torch.where(rand(4, Hs, Ws) < 0.05, -0.0, w)
        w = torch.where(rand(4, Hs, Ws) < 0.002, float("nan"), w)
        w = torch.where(rand(4, Hs, Ws) < 0.002, float("inf"), w)
        count = torch.where(rand(1, Hs, Ws) < 0.33, 0.0, torch.floor(4 * rand(1, Hs, Ws)) + 1)
        return hist.contiguous(), torch.cat([res, w, count]).contiguous()

    cases = [(Hs, Ws, C) for C in (10, 1, 3, 16) for Hs, Ws in ((61, 97), (29, 7))]
    for Hs, Ws, C in [(H, W, 10)] + cases + [(H, W, 16)]:
        hist, rw = inputs(Hs, Ws, C=C)
        for my, mx in ((0, 0), (3, -5), (-2, 7), (Hs + 5, -(Ws + 3))):
            out = coef_fetch(hist, rw, my, mx)
            torch.cuda.synchronize()
            check_bits(f"coef_fetch {Ws}x{Hs} C {C} motion ({my}, {mx})", out,
                       coef_fetch_plain(hist, rw, my, mx))
            full = fetch_full_tiles(hist, my, mx)
            log(f"kernel coef_fetch edge hold {Ws}x{Hs} C {C} motion ({my}, {mx}): equal bit "
                f"for bit; {int(full.sum())} of {full.numel()} tiles on the 16-view sum")
    hist, rw = inputs(H, W, planted=False)
    TH, TW = FETCH_TILE
    nan_hist = hist.clone()
    nan_hist[0, TH // 2::TH, TW // 2::TW] = float("nan")  # one NaN a tile
    times = {}
    for what, h in (("matched views", hist), ("16-view sum", nan_hist)):
        full = fetch_full_tiles(h, 0, 0)
        out = coef_fetch(h, rw, 0, 0)
        torch.cuda.synchronize()
        check_bits(f"coef_fetch 1080p {what}", out, coef_fetch_plain(h, rw, 0, 0))
        times[what] = dict(ms=cuda_ms(lambda: coef_fetch(h, rw, 0, 0), 50),
                           full_tiles=int(full.sum()), tiles=full.numel())
    times["plain_ms"] = cuda_ms(lambda: coef_fetch_plain(hist, rw, 0, 0), 3)
    log(f"kernel coef_fetch gate sides 1920x1080: {json.dumps(times)}")


K1A_FORMS = (("bf16", "mxu3"), ("fp16", "mxu3"), ("fp32", "both"), ("bf16", "both"),
             ("bf16", "dtype"), ("fp16", "both"), ("fp16", "dtype"), ("fp32", "dtype"))


def k1a_edge_holds(n=1 << 16):
    """K1a held against its plain version (every output on every ray,
    `check_dense`) on adversarial lanes (`k1a_edge_rays`: zero direction
    components against Cornell's axis-aligned walls, origins on a row's
    plane with Oz exactly 0, mind < 0, dead lanes with maxd <= mind, rays
    up through the floor under the tall box, whose bottom face lies in the
    floor's plane) in every form K1a runs (`K1A_FORMS`), with the fused
    shadow phase and, in the forms the packed epilogue takes, packed; on
    the flagship's table and on the table doubled (every row again with
    its id + 1000, first: exact ties in t, the smaller id found later).
    Logs the rays whose least accepted t is tied between rows."""
    import torch

    from low_precision_raytracer_tpu_torch.config import RenderConfig
    from low_precision_raytracer_tpu_torch.models.procedural import cornell_box_scene
    from low_precision_raytracer_tpu_torch.models.scene import flatten_frame
    from low_precision_raytracer_tpu_torch.ops import trace as T
    from low_precision_raytracer_tpu_torch.ops.dense_trace import (
        dense_trace,
        dense_trace_plain,
        k1a_edge_rays,
        tri_quantities,
    )

    for precision, fallback in K1A_FORMS:
        cfg = RenderConfig(width=W, height=H, precision=precision, triangle_fallback=fallback)
        frame = flatten_frame(cornell_box_scene(), cfg.prec, "cuda", 4, W, H)
        band = T.acceptance_band(frame, cfg, cfg.prec)
        coef = T.frame_table(frame, band)
        spec = {k: getattr(frame, k)[: frame.n_lights]
                for k in ("light_type", "light_pos", "light_dir")}
        lights = T.di_light_rows(frame, spec)
        d_mov = T.fused_moveforward(cfg.prec, band)
        c = frame.dense_center
        box = torch.tensor([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], device="cuda") - c
        spot = torch.tensor([-0.35, -1.0, -0.35], device="cuda") - c
        rays = k1a_edge_rays(coef, box[0].tolist(), box[1].tolist(), spot.tolist(), n, seed=5)
        tables = {"table": (coef, frame.dense_tri, frame.dense_obj),
                  "doubled": (torch.cat([coef, coef]).contiguous(),
                              torch.cat([frame.dense_tri + 1000, frame.dense_tri]).int().contiguous(),
                              torch.cat([frame.dense_obj, frame.dense_obj]).int().contiguous())}
        for tname, table in tables.items():
            args = rays + table
            forms = [dict(lights=lights, d_mov=d_mov)]
            if not cfg.prec.is_f32:  # the packed epilogue's forms
                forms.append(dict(pack=True))
            for extra in forms:
                out_k = dense_trace(*args, band=band, **extra)
                torch.cuda.synchronize()
                check_dense(out_k, dense_trace_plain(*args, band=band, **extra))
            t, _u, _v, geom = tri_quantities(table[0], rays[0], rays[1], band)
            ok = (geom & (t > rays[3][:, None]) & (t < rays[4][:, None])
                  & (table[1][None] != rays[2][:, None]) & torch.isfinite(t))
            tmin = torch.where(ok, t, float("inf")).min(dim=1).values
            ties = int((((t == tmin[:, None]) & ok).sum(dim=1) > 1).sum())
            log(f"kernel dense_trace edge hold {precision}-{fallback} {tname}: "
                f"{rays[0].shape[0]} rays equal{' (and packed)' if len(forms) > 1 else ''}; "
                f"{ties} rays with tied least t")


def out_names(out):
    """The names of a trace kernel's outputs: the packed epilogue's three
    or the full record."""
    return ("t", "row", "pk") if len(out) == 3 else ("t", "u", "v", "tri", "obj", "vis")


def check_dense(k, p):
    """K1a against its plain version: t, u, v, tri, obj, vis (the packed
    epilogue: t, row, pk) all equal on every ray.  -> max abs error (0)."""
    import torch

    for name, a, b in zip(out_names(k), k, p):
        if not torch.equal(a, b):
            raise AssertionError(f"dense_trace: {name} differs from the plain version on "
                                 f"{int((a != b).sum())} of {a.numel()} rays")
    return 0.0


def beside(name, older, kern, args, kw, out_p, check, reps=20, older_kw=None):
    """The older checkout's kernel (`--beside`) on the same inputs (its own
    keywords `older_kw`, by default `kw`): held against the plain version
    (`check(got, out_p)`), then both timed a b b a (`ab_ms`, `reps` calls a
    sample).  -> {ms_samples, beside_ms, beside_samples}."""
    import torch

    okw = kw if older_kw is None else older_kw
    prev = older(*args, **okw)
    torch.cuda.synchronize()
    check(prev, out_p)
    this, old = ab_ms([lambda: kern(*args, **kw), lambda: older(*args, **okw)], reps)
    log(f"kernel {name} beside the older checkout: ms {statistics.median(this):.4f} "
        f"[{statistics.median(old):.4f}]")
    return dict(ms_samples=this, beside_ms=statistics.median(old), beside_samples=old)


def k1a_culls(args, kw, out_p):
    """K1a's culled loops emulated in plain PyTorch on the card
    (`dense_trace_cull_plain`) on one launch's inputs, held equal to the
    plain version; -> the (ray, row) pairs and (warp, row) steps the loops
    visit, cull by sign and by range, and test in full, per phase."""
    from low_precision_raytracer_tpu_torch.ops.dense_trace import dense_trace_cull_plain

    out_e, counts = dense_trace_cull_plain(*args, **kw)
    for what, a, b in zip(out_names(out_e), out_e, out_p):
        if not bool((a == b).all()):
            raise AssertionError(f"dense_trace_cull_plain: {what} differs from the plain version")
    return counts


def kernel_phase(calls, names=("dense_trace", "coef_fetch", "temporal_accum", "wavelet_iter"),
                 tag=""):
    """Hold each kernel of `names` against its plain version on the
    recorded inputs; time both.  -> {name: report}."""
    import torch

    from low_precision_raytracer_tpu_torch.ops.dense_trace import dense_trace, dense_trace_plain
    from low_precision_raytracer_tpu_torch.ops.svgf_kernels import (
        coef_fetch,
        coef_fetch_plain,
        fetch_full_tiles,
        temporal_accum,
        temporal_accum_plain,
        wavelet_iter,
        wavelet_iter_plain,
        wavelet_staged_bytes,
    )

    pairs = {
        "dense_trace": (dense_trace, dense_trace_plain),
        "coef_fetch": (coef_fetch, coef_fetch_plain),
        "temporal_accum": (temporal_accum, temporal_accum_plain),
        "wavelet_iter": (wavelet_iter, wavelet_iter_plain),
    }
    reports = {}
    for name in names:
        kern, plain = pairs[name]
        if name not in calls:
            raise AssertionError(f"{name}: the main path made no call to record")
        per = []
        for args, kw, _ in calls[name]:
            out_k = kern(*args, **kw)
            torch.cuda.synchronize()
            out_p = plain(*args, **kw)
            torch.cuda.synchronize()
            HW = H * W
            if name == "dense_trace":
                err = check_dense(out_k, out_p)
                b_in = nbytes(*args[:8], args[8] if len(args) > 8 else kw.get("lights"))
                n_bytes = b_in + nbytes(*out_k)
                culls = k1a_culls(args, kw, out_p)
                n_ops = dense_trace_ops(args, kw, out_p, culls)
                # beside it the all-row count (every row of every live lane)
                extra = {"band": list(kw.get("band", ())), "culls": culls, "bound_ms_all_rows":
                         bound_ms(n_bytes, dense_trace_ops(args, kw, out_p))[0]}
                if kw.get("pack"):  # the full epilogue on the same rays, beside it
                    extra.update(pack=True, reduce5_ms=cuda_ms(
                        lambda: kern(*args, **dict(kw, pack=False)), 20))
                if BESIDE is not None:
                    extra.update(beside(name, BESIDE.dense_trace.dense_trace, kern, args, kw,
                                        out_p, check_dense))
            else:
                err = (check_svgf if name == "temporal_accum" else check_bits)(name, out_k, out_p)
                tensors = [a for a in args if isinstance(a, torch.Tensor)]
                if name == "temporal_accum":  # K3 reads geo7's first 6 planes only
                    tensors[1] = tensors[1][:6]
                outs = out_k if isinstance(out_k, tuple) else (out_k,)
                n_bytes = nbytes(*tensors) + nbytes(*outs)
                n_ops = {"coef_fetch": lambda: coef_fetch_ops(args[0].shape[0], HW),
                         "temporal_accum": lambda: temporal_ops(HW),
                         "wavelet_iter": lambda: wavelet_ops(HW)}[name]()
                extra = {}
                if name == "temporal_accum":
                    flat = lambda x: torch.cat([t.reshape(-1) for t in x])
                    a, b = flat(out_k), flat(out_p)
                    extra = {"values_differing_in_bits": int(
                        ((a.view(torch.int32) != b.view(torch.int32))
                         & ~(torch.isnan(a) & torch.isnan(b))).sum())}
                    if BESIDE is not None:
                        extra.update(beside(name, BESIDE.svgf_kernels.temporal_accum, kern,
                                            args, kw, out_p,
                                            lambda a, b: check_svgf(f"{name} (beside)", a, b)))
                if name == "wavelet_iter":
                    extra = {"stride": args[2], "prev_ms": PREV_K4_MS.get(args[2]),
                             "staged_bytes": wavelet_staged_bytes(H, W, args[2])}
                if name == "coef_fetch":
                    extra = {"full_tiles": int(fetch_full_tiles(args[0], *args[2:4]).sum())}
                    if BESIDE is not None:
                        extra.update(beside(name, BESIDE.svgf_kernels.coef_fetch, kern, args, kw,
                                            out_p, lambda a, b: check_bits(name, a, b)))
            ms = statistics.median(extra["ms_samples"]) if "ms_samples" in extra \
                else cuda_ms(lambda: kern(*args, **kw), 20)
            plain_ms = cuda_ms(lambda: plain(*args, **kw), 3)
            b_ms, b_by = bound_ms(n_bytes, n_ops)
            per.append(dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                            ratio=ms / b_ms, max_abs_err=err, bytes=n_bytes, ops=n_ops,
                            **extra))
            log(f"kernel {name}{tag}: {json.dumps(per[-1])}")
        mean = lambda k: statistics.fmean(p[k] for p in per)
        reports[name] = dict(
            max_abs_err=max(p["max_abs_err"] for p in per), ms=mean("ms"),
            plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
            bound_by=max(per, key=lambda p: p["bound_ms"])["bound_by"], per=per)
        if name == "dense_trace":
            reports[name]["bound_ms_all_rows"] = mean("bound_ms_all_rows")
    return reports


def path_phase(cuda_lib, scene_fn, want_fn, precision="bf16", frames_n=PATH_FRAMES,
               motion=None, fetch_timer=None, **cfg_kw):
    """`frames_n` frames at 1920x1080 through a fresh Renderer (seed 0)
    with the counts zeroed just before; `want_fn(frame)` gives the
    launches each frame must make.  `motion`: None (a still scene at time
    0: the history fetch takes K2 from frame 1), 'camera' or 'objects'
    (frame f renders at time f / FPS; K2 launches once on each frame whose
    fetch took its path and never on the others, and each frame records
    its branch).  Unless objects move, no per-table cache builds after
    frame 0 (`dense_trace.TABLE_BUILDS`).  `fetch_timer` (a FetchTimer,
    installed): each frame records the ms of its texture fetches.  A scene
    with textures logs its atlas size.  -> (launch totals, per-frame
    records, peak GiB, the last image, the last frame's aux)."""
    import torch

    from low_precision_raytracer_tpu_torch.config import RenderConfig
    from low_precision_raytracer_tpu_torch.ops import dense_trace
    from low_precision_raytracer_tpu_torch.ops.texture import has_textures
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer

    renderer = Renderer(scene_fn(), RenderConfig(width=W, height=H, precision=precision,
                                                 **cfg_kw))
    if has_textures(renderer.scene):
        atlas = renderer.scene.tex_data
        log(f"atlas: {atlas.numel() / 2**20:.3f} MiB on the card, "
            f"{renderer.scene.tex_width.numel()} textures, {atlas.shape[0]} texels")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    frames = []
    img = None
    for f in range(frames_n):
        before = dict(cuda_lib.LAUNCHES)
        builds = dense_trace.TABLE_BUILDS
        t0 = time.perf_counter()
        img, aux = renderer.render(time=f / FPS if motion else 0.0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: cuda_lib.LAUNCHES[k] - before[k] for k in before}
        frames.append(dict(frame=f, ms=ms, flatten_ms=aux["flatten_ms"],
                           n_rays=int(aux["n_rays"]), fast_fetch=aux["svgf_fast_path"],
                           table_builds=dense_trace.TABLE_BUILDS - builds, launches=counts))
        if fetch_timer is not None:
            rec = frames[-1]
            rec["fetch_ms"], rec["fetch_calls"], rec["fetch_bound_ms"] = fetch_timer.take()
        log(f"frame {json.dumps(frames[-1])}")
    totals = dict(cuda_lib.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    for rec in frames:
        got, want = rec["launches"], want_fn(rec["frame"])
        if motion:  # K2 on exactly the frames whose fetch took its path
            want = {**want, "coef_fetch": 1 if rec["fast_fetch"] else 0}
        elif rec["fast_fetch"] != (rec["frame"] > 0):
            raise AssertionError(f"frame {rec['frame']}: history fetch fast path "
                                 f"{rec['fast_fetch']}")
        if set(got) != set(want) or not all(
                w(got) if callable(w) else got[k] == w for k, w in want.items()):
            raise AssertionError(f"frame {rec['frame']}: launches {got} != {want}")
        if motion != "objects" and rec["frame"] > 0 and rec["table_builds"]:
            raise AssertionError(f"frame {rec['frame']}: {rec['table_builds']} per-table "
                                 "builds, though no object moved")
    if tuple(img.shape) != (H, W, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("image is not a finite (H, W, 3) array")
    if float(img.min()) < 0 or float(img.max()) > 1 or float(img.std()) < 1e-3:
        raise AssertionError("image is outside [0, 1] or constant")
    return totals, frames, peak_gib, img, aux


def report_path(name, frames, peak_gib, totals):
    steady = frames[2:] or frames
    frame_ms = statistics.median(f["ms"] for f in steady)
    flatten_ms = statistics.median(f["flatten_ms"] for f in steady)
    n_rays = statistics.median(f["n_rays"] for f in steady)
    prev = f"  (before: {PREV_FRAME_MS[name]})" if name in PREV_FRAME_MS else ""
    branches = "".join("-" if f["fast_fetch"] is None else "K" if f["fast_fetch"] else "t"
                       for f in frames)
    fetch = (f"texture fetch ms per frame {statistics.median(f['fetch_ms'] for f in steady):.4f}"
             f" ({steady[0]['fetch_calls']} calls; bytes bound "
             f"{steady[0]['fetch_bound_ms']:.4f})  " if "fetch_ms" in frames[0] else "")
    log(f"path {name}: frame_ms(median of frames {len(frames) - len(steady) + 1}-{len(frames)}) "
        f"{frame_ms:.3f}{prev}  "
        f"{fetch}flatten_ms {flatten_ms:.4f} (frame 0 {frames[0]['flatten_ms']:.3f})  "
        f"Mrays/s {n_rays / frame_ms / 1e3:.3f}  n_rays {n_rays}  "
        f"peak memory {peak_gib:.3f} GiB  fetch per frame {branches} (K: K2, t: the plain "
        f"2x2 take)  table builds after frame 0 "
        f"{sum(f['table_builds'] for f in frames[1:])}  launches {json.dumps(totals)}")


def reference_phase(scene_fn, frames, precision="bf16", moving=False, hold=True, **cfg_kw):
    """A small frame on the card against the plain versions on the CPU,
    same uniforms (and TAA bits, where the TAA half runs): PSNR >= 35 dB
    and validity agreement >= 0.999 on every frame (the port-vs-JAX bars of
    tests/test_torch_render_e2e.py; `hold=False`: measured, not held).
    `moving`: frame f at time f / FPS.  -> (PSNRs, agreements)."""
    import torch

    from low_precision_raytracer_tpu_torch.config import RenderConfig
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer, taa_active

    cfg = RenderConfig(width=REF_SIZE, height=REF_SIZE, precision=precision, **cfg_kw)
    gpu = Renderer(scene_fn(), cfg)
    cpu = Renderer(scene_fn(), cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    psnrs, agrees = [], []
    for f in range(frames):
        us = torch.rand((7 * REF_SIZE * REF_SIZE,), generator=gen)
        bits = (torch.randint(0, 1 << 32, (REF_SIZE, REF_SIZE), generator=gen,
                              dtype=torch.int64) if taa_active(cfg) else None)
        t = f / FPS if moving else 0.0
        img_g, aux_g = gpu.render(time=t, uniforms=[us.cuda()],
                                  taa_bits=None if bits is None else bits.cuda())
        img_c, aux_c = cpu.render(time=t, uniforms=[us], taa_bits=bits)
        mse = float(((img_g.cpu().double() - img_c.double()) ** 2).mean())
        psnr = float("inf") if mse == 0 else 10 * math.log10(1.0 / mse)
        agree = float((aux_g["valid"].cpu() == aux_c["valid"]).float().mean())
        if hold and (psnr < 35 or agree < 0.999):
            raise AssertionError(f"reference frame {f}: PSNR {psnr:.2f} dB, valid agreement {agree}")
        psnrs.append(psnr)
        agrees.append(agree)
    return psnrs, agrees


def profile_frame(name, scene_fn, precision="bf16"):
    """Device time by kernel over one steady 1080p frame."""
    import torch

    from low_precision_raytracer_tpu_torch.config import RenderConfig
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer

    r = Renderer(scene_fn(), RenderConfig(width=W, height=H, precision=precision))
    for _ in range(3):
        r.render()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        r.render()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=30)
    log(f"profile {name}: frame wall {wall:.3f} ms")
    for line in table.splitlines():
        log(f"profile {name}: " + line)


# ---------------------------------------------------------------------------
# The interactive path: animated Cornell with a moving camera and TAA 0.3;
# the Sponza-class frame with a turning camera


def animated_scene():
    """The animated Cornell box (its tall box orbits and turns, its lamp
    bobs) with the camera dollying toward the box, 0.02 units a frame at
    FPS frames a second (`tools/frame_times.py:animated_scene`)."""
    from low_precision_raytracer_tpu_torch.tools.frame_times import animated_scene as scene

    return scene()


def sponza_camera_scene():
    """The Sponza-class frame, still, with the camera turning YAW_DEG
    degrees a frame about the vertical axis."""
    import numpy as np

    from low_precision_raytracer_tpu_torch.models.hierarchy import Sampler
    from low_precision_raytracer_tpu_torch.models.procedural import sponza_like_scene

    scene = sponza_like_scene()
    h = math.radians(YAW_DEG * FPS) / 2
    scene.active_camera.animation.rotation = Sampler(
        times=np.array([0.0, 1.0], np.float32),
        values=np.array([[0, 0, 0, 1], [0, math.sin(h), 0, math.cos(h)]], np.float32))
    return scene


def animated_kernel_phase(cfg):
    """Warm-up frames of the animated path (frame f at time f / FPS, then
    one frame more at the last time: the animation paused) record each
    kernel's inputs and the history fetch's branch.  Every kernel is held
    against its plain version on the last frame whose fetch took K2 (K1a
    with its shadow phase under the moved lamp, K2 bit for bit on history
    reprojected through moving objects and camera), and the plain 2x2 take
    is timed on the inputs of the last frame that took it.  -> reports."""
    import torch

    from low_precision_raytracer_tpu_torch.ops import reproject
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer

    warm = Renderer(animated_scene(), cfg)
    fetches, orig = [], reproject.fetch_weighted_packed

    def rec(*args):
        out = orig(*args)
        fetches.append((args, out[1]))
        return out

    reproject.fetch_weighted_packed = rec
    fast_calls = slow_args = None
    times = [f / FPS for f in range(PATH_FRAMES)] + [(PATH_FRAMES - 1) / FPS]
    try:
        for t in times:
            calls = capture_inputs(warm, 1, times=[t])
            args, fast = fetches[-1]
            if fast:
                fast_calls = calls
            else:
                slow_args = args
    finally:
        reproject.fetch_weighted_packed = orig
    branches = "".join("K" if fast else "t" for _a, fast in fetches)
    log(f"animated warm-up: fetch per frame {branches} (times {times})")
    del warm
    if fast_calls is None:
        raise AssertionError("animated: no warm-up frame's history fetch took K2")
    reports = kernel_phase(fast_calls, tag=" animated")
    if slow_args is not None:
        ms = cuda_ms(lambda: orig(*slow_args), 10)
        log(f"animated: the plain 2x2 take's fetch (with its branch test) {ms:.4f} ms, "
            f"K2 {reports['coef_fetch']['ms']:.4f} ms on the paused frame")
    torch.cuda.empty_cache()
    return reports


# ---------------------------------------------------------------------------
# Textured glTF scenes: the Khronos BoxTextured sample and the textured
# Sponza-class .glb of tools/textured_scene.py

TEX_SIZE = 1024  # the textured Sponza-class scene's texture side
BOX_GLTF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "assets",
                        "BoxTextured.gltf")


class FetchTimer:
    """While entered, times every `sample_texture` call of shade with CUDA
    events and counts the bytes a fused fetch would move (ids and uv read,
    four RGBA8 taps a pixel, the RGBA f32 result written); `take()` ->
    (ms summed since the last take, calls, the bytes' bound in ms)."""

    def __enter__(self):
        import torch

        from low_precision_raytracer_tpu_torch.ops import shade

        self.events, self.bytes, self.orig = [], 0, shade.sample_texture

        def timed(scene, tex_id, uv):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = self.orig(scene, tex_id, uv)
            e1.record()
            self.events.append((e0, e1))
            self.bytes += nbytes(tex_id, uv, out) + 16 * tex_id.numel()
            return out

        shade.sample_texture = timed
        return self

    def __exit__(self, *exc):
        from low_precision_raytracer_tpu_torch.ops import shade

        shade.sample_texture = self.orig

    def take(self):
        import torch

        torch.cuda.synchronize()
        ms = sum(a.elapsed_time(b) for a, b in self.events)
        out = ms, len(self.events), bound_ms(self.bytes, 0)[0]
        self.events, self.bytes = [], 0
        return out


# the flagship Cornell camera's x / y offset (`models/procedural.py`): it
# keeps pixel centres off the box face's diagonal edge
BOX_CAMERA_OFFSET = (0.0131, 0.0077)


def box_scene(offset=(0.0, 0.0)):
    """BoxTextured.gltf (12 triangles, a 64 x 64 sRGB checker PNG) with the
    camera (z = 2, fov pi/3) and the lamp tests/test_gltf.py gives it, the
    camera moved by `offset` in x, y."""
    import numpy as np

    from low_precision_raytracer_tpu_torch.models.gltf import load_gltf
    from low_precision_raytracer_tpu_torch.models.hierarchy import (
        LIGHT_POINT,
        CameraObject,
        LightObject,
    )

    scene = load_gltf(BOX_GLTF)
    cam = CameraObject(name="cam", fov_y=np.pi / 3)
    cam.translation = np.array([*offset, 2.0], np.float32)
    scene.root.add(cam)
    scene.active_camera = cam
    lamp = LightObject(name="lamp", light_type=LIGHT_POINT,
                       intensity=np.array([40.0, 40.0, 40.0], np.float32))
    lamp.translation = np.array([0.0, 0.0, 2.5], np.float32)
    scene.root.add(lamp)
    return scene


def timed_load(name, load):
    """-> a scene function handing out copies of `load()`'s scene, the load
    (parse plus PNG decode) timed once."""
    import copy

    t0 = time.perf_counter()
    base = load()
    seconds = time.perf_counter() - t0
    log(f"load {name}: {seconds:.3f} s host (parse + decode), {len(base.textures)} textures, "
        f"{sum(t.nbytes for t in base.textures) / 2**20:.3f} MiB of texels")
    return lambda: copy.deepcopy(base)


def fetch_probe(scene_fn, precision="bf16"):
    """One 64x64 frame on the card and on the CPU (same uniforms) with
    every `sample_texture` call recorded: per shade round, how many uv
    components differ between the two and by how much, and the fetch run
    on the card's own inputs on the CPU, held within 1e-6 of the card's
    output (the bar of tests/test_torch_texture.py against the JAX
    fetch).  It tells a texture's amplification of upstream ulps apart
    from the fetch's own arithmetic."""
    import torch

    from low_precision_raytracer_tpu_torch.config import RenderConfig
    from low_precision_raytracer_tpu_torch.ops import shade
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer

    cfg = RenderConfig(width=REF_SIZE, height=REF_SIZE, precision=precision)
    us = torch.rand((7 * REF_SIZE * REF_SIZE,), generator=torch.Generator().manual_seed(1))
    orig, calls = shade.sample_texture, {"cuda": [], "cpu": []}

    def recorder(into):
        def rec(*args):
            out = orig(*args)
            into.append((args, out))
            return out
        return rec

    try:
        for dev in ("cuda", "cpu"):
            shade.sample_texture = recorder(calls[dev])
            Renderer(scene_fn(), cfg, device=dev).render(uniforms=[us.to(dev)])
    finally:
        shade.sample_texture = orig
    for r, (((sc, tid, uv), out), ((_s, tid_c, uv_c), _o)) in enumerate(
            zip(calls["cuda"], calls["cpu"])):
        du = (uv.cpu().float() - uv_c.float()).abs()
        err = float((orig(_s, tid.cpu(), uv.cpu()) - out.cpu()).abs().max())
        log(f"fetch probe {precision} round {r}: ids equal {torch.equal(tid.cpu(), tid_c)}, uv "
            f"components differing card vs CPU {int((du > 0).sum())} of {du.numel()} (max "
            f"{float(du.max()):.3g}); the fetch on the card's inputs, card vs CPU max abs err "
            f"{err:.3g}")
        if err > 1e-6:
            raise AssertionError(f"fetch probe: the card's fetch differs from the CPU's by {err}")


def textured_phases(run_path, counts, cfg, tmp):
    """The two textured paths (bf16, 1920x1080): textured-box (K1a) and
    textured-sponza (K1b), each loaded once and timed, rendered 8 frames
    with every texture fetch timed (`FetchTimer`), checked to carry its
    textures into the frame, and held at 64x64 against the plain versions
    on the CPU; K1b, K3 and K4 held against their plain versions on
    textured-sponza's inputs."""
    import torch

    from low_precision_raytracer_tpu_torch.models.materials import NO_TEX
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer
    from low_precision_raytracer_tpu_torch.tools.textured_scene import (
        textured_sponza_scene,
        write_textured_sponza,
    )

    box_fn = timed_load("textured-box", box_scene)
    with FetchTimer() as timer:
        _t, _img, aux = run_path("textured-box", box_fn, counts(dense_trace=2),
                                 fetch_timer=timer)
    # the face centre shows both checker colours: red cells (G << R), white (G ~ R)
    c = aux["albedo"][H // 2 - 100:H // 2 + 100, W // 2 - 100:W // 2 + 100]
    ok = aux["valid"][H // 2 - 100:H // 2 + 100, W // 2 - 100:W // 2 + 100]
    ratio = (c[..., 1] / c[..., 0].clamp(min=1e-6))[ok]
    log(f"textured-box: face centre G/R of the albedo min {float(ratio.min()):.4f} "
        f"max {float(ratio.max()):.4f} over {int(ok.sum())} pixels")
    if not (float(ratio.min()) < 0.25 and float(ratio.max()) > 0.8):
        raise AssertionError("textured-box: the face centre does not show both checker colours")
    del aux
    # With the camera on the face's axis, a 64x64 frame's anti-diagonal pixel
    # centres aim exactly at the face's diagonal edge, where the strict test
    # rejects the ray in both triangles and one ulp between the card's and
    # the CPU's camera grid decides hit or miss (ROADMAP queue 3, "Hits on a
    # quad's diagonal"): measured and printed, not held.  The held
    # reference moves the camera by the flagship's offset.
    psnrs, agree = reference_phase(box_fn, 1, hold=False)
    log(f"reference textured-box, centred camera (not held): PSNR dB {psnrs[0]:.2f}, "
        f"valid agreement {agree[0]:.5f}")
    psnrs, _agree = reference_phase(lambda: box_scene(BOX_CAMERA_OFFSET), REF_FRAMES)
    log(f"reference textured-box (camera offset {BOX_CAMERA_OFFSET}): {REF_SIZE}x{REF_SIZE} "
        "card vs plain-on-CPU PSNR dB " + " ".join(f"{p:.2f}" for p in psnrs))

    path = os.path.join(tmp, "textured_sponza.glb")
    t0 = time.perf_counter()
    write_textured_sponza(path, tex_size=TEX_SIZE)
    log(f"textured-sponza: wrote {os.path.getsize(path) / 2**20:.3f} MiB .glb "
        f"({TEX_SIZE}^2 textures) in {time.perf_counter() - t0:.3f} s")
    sponza_fn = timed_load("textured-sponza", lambda: textured_sponza_scene(path))
    warm = Renderer(sponza_fn(), cfg)
    launches = capture_sponza_launches(warm, 2)
    calls = capture_inputs(warm, 1)
    del warm
    k1b_phase(launches, reps=5, plain_on_slice=True, scene="textured-sponza")
    kernel_phase(calls, names=("temporal_accum", "wavelet_iter"), tag=" textured-sponza")
    del launches, calls
    torch.cuda.empty_cache()
    with FetchTimer() as timer:
        _t, _img, aux = run_path("textured-sponza", sponza_fn, counts(dense_trace_multi=4),
                                 fetch_timer=timer)
    # the textures reach the frame: the albedo differs from the factors'
    plain_host = sponza_fn()
    for m in plain_host.materials:
        m.tex_color = NO_TEX
    _img, aux0 = Renderer(plain_host, cfg).render()
    valid = aux["valid"] & aux0["valid"]
    differs = ((aux["albedo"] - aux0["albedo"]).abs().amax(dim=-1) > 1e-3)[valid]
    share = float(differs.float().mean())
    log(f"textured-sponza: albedo differs from the untextured materials' on {share:.4f} of "
        f"{int(valid.sum())} valid pixels")
    if share <= 0.5:
        raise AssertionError("textured-sponza: the textures do not reach the albedo plane")
    del aux, aux0
    torch.cuda.empty_cache()
    psnrs, _agree = reference_phase(sponza_fn, SPONZA_REF_FRAMES)
    log(f"reference textured-sponza: {REF_SIZE}x{REF_SIZE} card vs plain-on-CPU PSNR dB "
        + " ".join(f"{p:.2f}" for p in psnrs))
    fetch_probe(sponza_fn)


# ---------------------------------------------------------------------------
# Sponza-class frame: K1b


def capture_sponza_launches(renderer, frames):
    """Render `frames` frames; -> the last frame's K1b launches, in order
    [(kind, args, kwargs, unsorted_args | None)]: primary, round-0
    shadows, GI bounce (sorted), round-1 shadows (sorted).  For a sorted
    launch `args` are the kernel's (sorted) inputs and `unsorted_args`
    the rays as the sorted launch received them."""
    from low_precision_raytracer_tpu_torch.ops import dense_trace, trace

    calls, sorted_calls = [], []
    orig_multi, orig_sorted = dense_trace.dense_trace_multi, trace.dense_trace_multi_sorted

    def rec_multi(*args, **kw):
        calls.append((args, kw))
        return orig_multi(*args, **kw)

    def rec_sorted(*args, **kw):
        sorted_calls.append((args, kw))
        return orig_sorted(*args, **kw)

    try:
        dense_trace.dense_trace_multi = rec_multi
        trace.dense_trace_multi = rec_multi
        trace.dense_trace_multi_sorted = rec_sorted
        for _ in range(frames):
            calls.clear()
            sorted_calls.clear()
            renderer.render()
    finally:
        dense_trace.dense_trace_multi = orig_multi
        trace.dense_trace_multi = orig_multi
        trace.dense_trace_multi_sorted = orig_sorted
    kinds = ("primary", "shadow0", "gi_sorted", "shadow1_sorted")
    if len(calls) != 4 or len(sorted_calls) != 2:
        raise AssertionError(f"Sponza frame: {len(calls)} K1b launches "
                             f"({len(sorted_calls)} sorted), want 4 (2)")
    unsorted = [None, None, sorted_calls[0][0], sorted_calls[1][0]]
    return [(k, a, kw, u) for k, (a, kw), u in zip(kinds, calls, unsorted)]


def k1b_phase(launches, check_rays=CHECK_RAYS, reps=10, plain_on_slice=False,
              scene="sponza", check_by_kind=None, scan_rays=None, scan_bound=True):
    """K1b on each recorded launch: timed on the full launch, held against
    the plain version on a strided slice of `check_rays` rays (every output
    exact; `check_by_kind`: another count for some kinds, the plain version
    then in slabs of 2^26 (ray, row) pairs); its bound from the data
    (`walk_ops` on the launch's chunk tree and slice boxes; the chunk-row count,
    128 rows per chunk entered, beside it); the walk also timed in the
    other persistence (`k1b_launch`); the sorted launches also unsorted and
    with their sort.  `plain_on_slice`: the plain version (an all-pairs
    test) is timed on the slice, beside the kernel on the same slice,
    instead of on the full launch; `check_rays=0`: no plain hold.  Under a
    widened band the walk grows each box for its ray: the bound counts
    those (`walk_growth`), beside the unpadded boxes' count and the all-row
    scan's,
    with the slices entered per live ray under both, and the walk is held
    bit for bit against the scan kernel on every ray (or `scan_rays`);
    `scan_bound=False` leaves out the scan's count (its any-hit count walks
    the rows of every blocked ray in plain PyTorch).  -> report dict."""
    import torch

    from low_precision_raytracer_tpu_torch.ops.dense_trace import (
        STRICT,
        dense_trace_multi,
        dense_trace_multi_plain,
        dense_trace_multi_sorted,
        k1b_launch,
    )

    per = []
    for kind, args, kw, unsorted in launches:
        R = args[0].shape[0]
        # the plain version reads no box: the wrapper's slice boxes and pads
        # are not its
        pkw = {k: v for k, v in kw.items() if k not in ("slices", "pads")}
        n_check = (check_by_kind or {}).get(kind, check_rays)
        big = n_check != check_rays
        out = dense_trace_multi(*args, **kw)
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        plain_ms, err = None, 0.0
        sel = torch.arange(0, R, max(1, R // max(1, n_check)), device=args[0].device)[:n_check]
        sub = [a[sel].contiguous() if a.shape[0] == R else a for a in args]
        if n_check:
            pkw_check = dict(pkw, slab_elems=1 << 26) if big else pkw
            t0.record()
            ref = dense_trace_multi_plain(*sub, **pkw_check)
            t1.record()
            t1.synchronize()
            plain_ms = t0.elapsed_time(t1)
            for name, a, b in zip(out_names(out), out, ref):
                a = a[sel]
                if not torch.equal(a, b):
                    raise AssertionError(f"dense_trace_multi {scene} {kind}: {name} differs from "
                                         f"the plain version on {int((a != b).sum())} of "
                                         f"{sel.numel()} rays")
                if a.dtype == torch.float32:
                    err = max(err, float((a - b).abs().max()))
            del ref
        tri_out = out[1] if kw.get("pack") else out[3]  # the row, or tri
        # the bound: any-hit rays need the boxes up to their closest blocker
        t_final = out[0] if not kw.get("find_any") else torch.where(
            out[3] >= 0, dense_trace_multi(*args, **dict(kw, find_any=False))[0], 1e5)
        blocked = out[3] >= 0 if kw.get("find_any") else None
        band = kw.get("band")
        widened = band is not None and band.widened
        tree, slices = kw["tree"], kw.get("slices")
        growth = walk_growth(args, kw, tree, t_final, slices) if widened else None
        n_ops, n_boxes, n_rows, per_ray = walk_ops(args, t_final, tree, band, blocked=blocked,
                                                   slices=slices, growth=growth)
        n_bytes = nbytes(*args, tree.boxes, slices) + nbytes(*out)
        if widened:  # the pads the walk reads
            n_bytes += nbytes(growth[0].tree, growth[0].slices, growth[1])
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        ms = cuda_ms(lambda: dense_trace_multi(*args, **kw), reps)
        if n_check and not plain_on_slice:
            torch.cuda.synchronize()
            t0.record()
            dense_trace_multi_plain(*args, **pkw)
            t1.record()
            t1.synchronize()
            plain_ms = t0.elapsed_time(t1)
        rec = dict(kind=kind, rays=R, live=int((args[4] > args[3]).sum()),
                   hits=int((tri_out >= 0).sum()), ms=ms, prev_ms=PREV_LAUNCH_MS.get((scene, kind)),
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                   checked_rays=int(sel.numel()), bytes=n_bytes, ops=n_ops,
                   boxes_entered=n_boxes, rows_tested=n_rows)
        rec["ratio"] = ms / b_ms
        live = args[4] > args[3]
        rec["slices_per_live_ray"] = _quantiles(per_ray[live])
        if widened:  # beside: the unpadded boxes' count, the all-row scan
            u_ops, _b, u_rows, u_per = walk_ops(args, t_final, kw["tree"], band,
                                                blocked=blocked, slices=kw.get("slices"))
            rec.update(slices_per_live_ray_unpadded=_quantiles(u_per[live]),
                       rows_tested_unpadded=u_rows, bound_ms_unpadded=bound_ms(n_bytes, u_ops)[0])
            if scan_bound:
                s_ops = walk_ops(args, t_final, kw["tree"], band, blocked=blocked, scan=True)[0]
                rec["bound_ms_scan"] = bound_ms(n_bytes, s_ops)[0]
            rec.update(scan_hold(f"dense_trace_multi {scene} {kind}", out, args, kw,
                                 scan_rays))
        # the chunk-row bound (128 rows a chunk entered), the other persistence
        c_ops, _b, c_rows, _p = walk_ops(args, t_final, tree, band, blocked=blocked,
                                         growth=growth)
        rec.update(bound_ms_chunk_rows=bound_ms(n_bytes, c_ops)[0], rows_chunk_rows=c_rows)
        rec["ratio_chunk_rows"] = ms / rec["bound_ms_chunk_rows"]
        persist = not kw.get("find_any")  # the wrapper persists in any hit
        rec["other_persist"] = persist
        rec["other_persist_ms"] = cuda_ms(lambda: k1b_launch(
            *args[:8], kw["tree"], kw.get("slices"), kw.get("find_any", False), band or STRICT,
            kw.get("pack", False), persist=persist, pads=kw.get("pads")), reps)
        if kw.get("pack"):  # the full epilogue on the same rays, beside it
            rec["reduce5_ms"] = cuda_ms(lambda: dense_trace_multi(*args, **dict(kw, pack=False)),
                                        reps)
        if plain_on_slice and n_check:
            rec["plain_ms_on"] = "slice"
            rec["slice_ms"] = cuda_ms(lambda: dense_trace_multi(*sub, **kw), reps)
        if unsorted is not None:
            srt = dense_trace_multi_sorted(*unsorted, **kw)
            direct = dense_trace_multi(*unsorted, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(srt, direct)):
                raise AssertionError(f"dense_trace_multi {kind}: sorted launch differs "
                                     "from the unsorted one")
            rec["unsorted_ms"] = cuda_ms(lambda: dense_trace_multi(*unsorted, **kw), 10)
            rec["sorted_total_ms"] = cuda_ms(lambda: dense_trace_multi_sorted(*unsorted, **kw), 5)
            rec["sort_unsort_ms"] = rec["sorted_total_ms"] - ms
        per.append(rec)
        log(f"kernel dense_trace_multi {scene}: {json.dumps(rec)}")
    mean = lambda k: statistics.fmean(p[k] for p in per) if per[0].get(k) is not None else None
    log(f"kernel dense_trace_multi {scene}: mean ms {mean('ms')} over {len(per)} launches "
        f"(before: {PREV_MEAN_MS.get(scene)})")
    return dict(max_abs_err=max(p["max_abs_err"] for p in per), ms=mean("ms"),
                plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
                bound_by=max(per, key=lambda p: p["bound_ms"])["bound_by"],
                scan_ms=mean("scan_ms"), launches=per)


def k1b_edge_holds(launches):
    """K1b held bit for bit against its plain version on edge cases made
    from the Sponza-class frame's recorded launches: every ray with a zero
    direction component (the sun of `sponza_like_scene` has dx = 0) of the
    round-0 shadow launch; a launch of 1,007 rays (not a multiple of 32);
    4,096 primary rays with three whole warps dead (maxd = 0) and one
    partly; and the overflow status, raised when the walk's stack is
    smaller than the tree's depth needs."""
    import torch

    from low_precision_raytracer_tpu_torch.ops.dense_trace import (
        STRICT,
        dense_trace_multi,
        dense_trace_multi_plain,
        k1b_launch,
        walk_stack,
    )

    by_kind = {k: (a, kw) for k, a, kw, _u in launches}

    def hold(what, args, kw):
        out = dense_trace_multi(*args, **kw)
        torch.cuda.synchronize()
        ref = dense_trace_multi_plain(*args, **{k: v for k, v in kw.items()
                                                if k not in ("slices", "pads")})
        for name, a, b in zip(out_names(out), out, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"dense_trace_multi edge hold {what}: {name} differs on "
                                     f"{int((a != b).sum())} of {a.numel()} rays")
        hits = out[1] if kw.get("pack") else out[3]
        log(f"kernel dense_trace_multi edge hold {what}: {args[0].shape[0]} rays equal, "
            f"{int((hits >= 0).sum())} hits")

    def take(args, idx):
        R = args[0].shape[0]
        return [a[idx].contiguous() if a.shape[0] == R else a for a in args]

    args, kw = by_kind["shadow0"]
    zero = torch.nonzero((args[1] == 0).any(dim=1) & (args[4] > args[3]))[:, 0]
    if zero.numel() == 0:
        raise AssertionError("edge hold: the round-0 shadows have no live ray with a zero "
                             "direction component")
    hold(f"zero direction component (shadow0, {int(zero.numel())} live rays)", take(args, zero),
         kw)
    args, kw = by_kind["primary"]
    hold("1,007 rays", take(args, torch.arange(1007, device=args[0].device)), kw)
    sub = take(args, torch.arange(0, 4096 * 401, 401, device=args[0].device))
    maxd = sub[4].clone()
    for lo, hi in ((32, 64), (64, 96), (1024, 1056), (2000, 2013)):
        maxd[lo:hi] = 0.0
    sub[4] = maxd
    hold("dead warps (4,096 rays, lanes 32-95 and 1024-1055 dead)", sub, kw)
    tree = kw["tree"]
    try:
        k1b_launch(*args[:8], tree, kw["slices"], False, kw.get("band", STRICT), stack=2)
        torch.cuda.synchronize()
    except RuntimeError as e:
        if "overflow" not in str(e):
            raise
        log(f"kernel dense_trace_multi edge hold overflow: a stack of 2 on a "
            f"{len(tree.sizes)}-level tree (walk_stack {walk_stack(tree)}) raised: {e}")
    else:
        raise AssertionError("edge hold: a stack of 2 entries did not overflow")


# ---------------------------------------------------------------------------
# colonnade-83k: K1b at 647 chunks, the per-ray wavefront (K5, schedule)


def colonnade_83k():
    from low_precision_raytracer_tpu_torch.models.procedural import sponza_like_scene

    return sponza_like_scene(8, 3)


def capture_big_launches(renderer, frames):
    """Render `frames` frames of a bf16 colonnade on the dense route
    (colonnade-83k, -328k); -> the last frame's trace launches in order
    [(route, args, kwargs)]: primary and round-0 shadows on K1b, the GI
    bounce and round-1 shadows on the wavefront."""
    from low_precision_raytracer_tpu_torch.ops import trace

    names = ("dense_trace_multi", "dense_trace_multi_sorted", "trace_rays_wavefront")
    orig = {n: getattr(trace, n) for n in names}
    calls = []

    def recorder(name):
        def rec(*args, **kw):
            calls.append((name, args, kw))
            return orig[name](*args, **kw)
        return rec

    try:
        for n in names:
            setattr(trace, n, recorder(n))
        for _ in range(frames):
            calls.clear()
            renderer.render()
    finally:
        for n, fn in orig.items():
            setattr(trace, n, fn)
    got = [(n, kw.get("find_any", False)) for n, _, kw in calls]
    want = [("dense_trace_multi", False), ("dense_trace_multi", True),
            ("trace_rays_wavefront", False), ("trace_rays_wavefront", True)]
    if got != want:
        raise AssertionError(f"colonnade frame: launches {got}, want {want}")
    return calls


def record_k5(args, kw):
    """Run one recorded wavefront launch and record each K5 call it makes
    (the first pass and each tail pass; in 'rounds' each round too):
    -> [(args, kwargs, the lanes' ray indices)]."""
    from low_precision_raytracer_tpu_torch.ops import wavefront as WF

    calls, rays = [], []
    real, lanes_fn = WF.assigned_test, WF._lanes

    def rec_lanes(L, r, gid):
        rays.append(r)
        return lanes_fn(L, r, gid)

    WF.assigned_test = lambda *a, **k: calls.append((a, k)) or real(*a, **k)
    WF._lanes = rec_lanes
    try:
        WF.trace_rays_wavefront(*args, **kw)
    finally:
        WF.assigned_test, WF._lanes = real, lanes_fn
    if len(calls) != len(rays):
        raise AssertionError(f"K5: {len(calls)} calls for {len(rays)} lane sets")
    return [(a, k, r) for (a, k), r in zip(calls, rays)]


def k5_same(name, got, ref):
    """K5's (t, row, pk) equal to the plain version's on every lane."""
    import torch

    if not all(torch.equal(x, y) for x, y in zip(got, ref)):
        raise AssertionError(f"{name}: differs from the plain version")


def k5_hold(name, a, k, check_emulation=False):
    """K5 on one call's inputs (`assigned_test(*a, **k)`) held bit for bit
    (t, row, pk) against `assigned_test_plain` on every lane, its counting
    form giving the same result; with `check_emulation` also against the
    plain emulation of its culled loop (`assigned_cull_plain`: results and
    counts) on a strided slice of BIG_CHECK lanes.  -> (result, counts,
    plain result, plain ms, emulated lanes)."""
    import torch

    from low_precision_raytracer_tpu_torch.ops import wavefront as WF

    lanes, (coef, tri, s_group, find_any) = a[:6], a[6:]
    P = lanes[5].shape[0]
    got = WF.assigned_test(*a, **k)
    counts = torch.zeros((P, len(WF.ASSIGNED_COUNTS)), dtype=torch.int32, device=coef.device)
    got_c = WF.assigned_test(*a, **k, counts=counts)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    ref = WF.assigned_test_plain(*a, slab_lanes=1 << 16)
    e1.record()
    e1.synchronize()
    for what, x, y, z in zip(("t", "row", "pk"), got, ref, got_c):
        if not torch.equal(x, y):
            raise AssertionError(f"wavefront_assigned {name}: {what} differs from the plain "
                                 f"version on {int((x != y).sum())} of {P} lanes")
        if not torch.equal(z, y):
            raise AssertionError(f"wavefront_assigned {name}: the counting form's {what} "
                                 f"differs on {int((z != y).sum())} of {P} lanes")
    n_emu = 0
    if check_emulation and P:
        lsel = torch.arange(0, P, max(1, P // BIG_CHECK), device=coef.device)[:BIG_CHECK]
        emu = WF.assigned_cull_plain(*(x[lsel].contiguous() for x in lanes), coef, tri,
                                     k["slices"], s_group, find_any)
        for what, x, y in zip(("t", "row", "pk"), emu, ref):
            if not torch.equal(x, y[lsel]):
                raise AssertionError(f"K5 emulation {name}: {what} differs from the plain "
                                     "version")
        if not torch.equal(emu[3], counts[lsel, :5].long()):
            bad = (emu[3] != counts[lsel, :5].long()).any(dim=0).tolist()
            raise AssertionError(f"wavefront_assigned {name}: the counting form's counts "
                                 f"differ from the emulation's in columns {bad}")
        n_emu = int(lsel.numel())
    return got, counts, ref, e0.elapsed_time(e1), n_emu


def k5_holds(scene, kind, args, kw, lights=1):
    """K5 on every call one recorded wavefront launch makes (`record_k5`),
    each held by `k5_hold` (every lane; the emulation and its counts on a
    strided slice), timed (beside the older checkout's K5, --beside, held
    too), with its bound from the counting form (a slab test per slice box
    tested, the row test per row tested: up to an any-hit lane's first
    accepted row) and the all-row count beside it (`assigned_ops_q`); per
    call the slices entered per lane under box_entry and the zero-axis
    rule (`leaf_split`) and the warp divergence: the slice bodies the warps
    ran against the most slices any of their lanes tested, and the lanes'
    share of those bodies.  Times are medians of `ab_ms`'s samples (beside
    the older checkout's in a b b a order), each sample about 2 ms of calls,
    their least and greatest beside them.  -> [report per call]."""
    import torch

    from low_precision_raytracer_tpu_torch.ops import wavefront as WF

    R = args[1].shape[0]
    reports = []
    for n, (a, k, ray) in enumerate(record_k5(args, kw)):
        lanes, (coef, tri, s_group, find_any) = a[:6], a[6:]
        P, q = lanes[5].shape
        TI = coef.shape[0]
        name = f"{scene} {kind} call {n}"
        got, counts, ref, plain_ms, n_emu = k5_hold(name, a, k, check_emulation=True)
        reps = sample_reps(lambda: WF.assigned_test(*a, **k))
        if BESIDE is not None:
            # the older kernel's own arguments: the keywords its wrapper takes
            older = BESIDE.wavefront.assigned_test
            b = beside(f"wavefront_assigned {name}", older, WF.assigned_test, a, k, ref,
                       lambda x, y: k5_same(f"beside K5 {name}", x, y), reps, older_kw={
                           n: v for n, v in k.items()
                           if n in inspect.signature(older).parameters})
            samples = [b["ms_samples"], b["beside_samples"]]
        else:
            samples = ab_ms([lambda: WF.assigned_test(*a, **k)], reps)
        ms = statistics.median(samples[0])
        beside_ms = statistics.median(samples[1]) if BESIDE is not None else None
        spread = lambda x: [x[0], x[-1]]
        c = counts.double().sum(dim=0).tolist()
        n_ops = c[2] * BOX_TEST_OPS + c[4] * TRI_TEST_OPS
        b_ms, b_by = bound_ms(nbytes(*lanes, coef, tri, k["slices"], *got), n_ops)
        NG = WF._n_groups(TI, s_group)
        ops_all = assigned_ops_q(lanes, got, TI, NG, s_group, find_any)
        b_all = bound_ms(nbytes(*lanes, coef, tri, *got), ops_all)[0]
        warp = counts[:, 6].long() // 32  # the warps the lanes ran in
        nw = int(warp.max()) + 1 if P else 0
        execs = torch.zeros(nw, dtype=torch.float64, device=coef.device).index_add_(
            0, warp, counts[:, 5].double())
        most = torch.zeros(nw, dtype=torch.float64, device=coef.device).scatter_reduce(
            0, warp, counts[:, 3].double(), "amax", include_self=False)
        ex, mo = float(execs.sum()), float(most.sum())
        rep = dict(scene=scene, kind=kind, call=n, lanes=P, q=q, s_group=s_group,
                   find_any=bool(find_any), ms=ms, ms_spread=spread(samples[0]),
                   beside_ms=beside_ms,
                   beside_spread=spread(samples[1]) if BESIDE is not None else None,
                   plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, bound_ms_all_rows=b_all,
                   ratio=ms / b_ms if b_ms else None, boxes_tested=c[2], slices_entered=c[0],
                   slices_entered_box_entry=c[1], slices_tested=c[3], rows_tested=c[4],
                   rows_all=ops_all / TRI_TEST_OPS, warp_slice_bodies=ex,
                   warp_slices_needed=mo, divergence=ex / mo if mo else None,
                   lane_share=c[3] / (32 * ex) if ex else None, max_abs_err=0.0,
                   checked_lanes=P, emulated_lanes=n_emu,
                   entered=leaf_split(lanes[1], torch.ones_like(ray, dtype=torch.bool),
                                      counts[:, 1], counts[:, 0], lights, ray, R))
        log(f"kernel wavefront_assigned {scene} {kind}: {json.dumps(rep)}")
        reports.append(rep)
    return reports


def k5_edge_holds(scene, kind, args, kw, n_lanes=4096):
    """K5's edge cases on one recorded wavefront launch's first pass, each
    held by `k5_hold` (bit for bit against the plain version, the
    emulation and its counts): the sun's lanes (d_x = 0) on groups whose
    slices they enter only under box_entry; lanes sent to the last group,
    whose last chunk is partial (rows >= TI), with q = 1 and with q = 4
    (the last group, a group past NG, the one before the last, the last);
    any-hit lanes whose first accepted row lies past their chunk's first
    slice; and, in closest hit, lanes whose winning row is copied into
    another slice of its chunk (the copies' plane offset exact or moved by
    one ulp either way, so keys tie in their 128-ulp bucket across slices)
    with every slice box its chunk's box.  -> report."""
    import torch

    from low_precision_raytracer_tpu_torch.ops import wavefront as WF
    from low_precision_raytracer_tpu_torch.ops.dense_trace import CHUNK, chunk_slices

    frame, origins, directions = args
    find_any = kw["find_any"]
    L = WF.setup(frame, origins, directions, kw["prec"], kw["skip_tri"], kw["min_dist"],
                 kw["max_dist"], find_any)
    dev = origins.device
    R, NG = origins.shape[0], L.lo.shape[0]
    k = min(WF.ONESHOT_K, NG)
    cand, _tcut = WF.schedule(L.lo, L.hi, L.o, L.d, torch.where(L.live, L.maxd, 0.0).contiguous(),
                              torch.full((R,), WF.INT32_MIN, dtype=torch.int32, device=dev),
                              L.id_bits, k, tree=L.tree)
    _pair, lanes = WF.pair_lanes(L, None, cand, L.live)
    P = lanes[0].shape[0]
    rest = (L.coef, L.tri, L.s_group, find_any)
    kws = dict(slices=L.slices)
    sub = lambda m: tuple(x[m].contiguous() for x in lanes)
    rep = dict(scene=scene, kind=kind, groups=NG, s_group=L.s_group, rows=int(L.coef.shape[0]))
    counts = torch.zeros((P, len(WF.ASSIGNED_COUNTS)), dtype=torch.int32, device=dev)
    WF.assigned_test(*lanes, *rest, **kws, counts=counts)
    spur = (lanes[1][:, 0] == 0) & (counts[:, 0] == 0) & (counts[:, 1] > 0)
    rep["sun_lanes_spurious"] = int(spur.sum())
    if rep["sun_lanes_spurious"]:
        k5_hold(f"{scene} {kind} spurious sun lanes", sub(spur) + rest, kws, True)
    strided = torch.arange(0, P, max(1, P // n_lanes), device=dev)[:n_lanes]
    base = sub(strided)
    last = torch.full((strided.numel(), 1), NG - 1, dtype=torch.int32, device=dev)
    k5_hold(f"{scene} {kind} last group", base[:5] + (last,) + rest, kws, True)
    four = torch.tensor([NG - 1, NG, max(NG - 2, 0), NG - 1], dtype=torch.int32, device=dev)
    k5_hold(f"{scene} {kind} q = 4 at the end", base[:5] + (four.expand(strided.numel(), 4)
                                                            .contiguous(),) + rest, kws, True)
    rep["last_chunk_rows"] = int(L.coef.shape[0] - (-(-L.coef.shape[0] // CHUNK) - 1) * CHUNK)
    ref = WF.assigned_test_plain(*lanes, *rest, slab_lanes=1 << 16)
    if find_any:
        later = (ref[1] >= 0) & (ref[1] % CHUNK >= 32)
        rep["any_hit_later_slice_lanes"] = int(later.sum())
        if rep["any_hit_later_slice_lanes"]:
            k5_hold(f"{scene} {kind} any hit past the first slice", sub(later) + rest, kws, True)
    else:  # ties across slices on a table with copied rows
        hit = torch.nonzero(ref[1] >= 0)[:, 0]
        pick = hit[torch.arange(0, hit.numel(), max(1, hit.numel() // n_lanes), device=dev)]
        row = ref[1][pick].long()
        to = torch.where(row % CHUNK < CHUNK - 32, row + 32, row - 32)
        coef2, tri2 = L.coef.clone(), L.tri.clone()
        copy = coef2[row].clone()
        step = torch.arange(pick.numel(), device=dev) % 3  # exact, one ulp down, one ulp up
        e2 = copy[:, 11]
        copy[:, 11] = torch.where(step == 1, torch.nextafter(e2, torch.full_like(e2, -3e38)),
                                  torch.where(step == 2, torch.nextafter(
                                      e2, torch.full_like(e2, 3e38)), e2))
        coef2[to] = copy
        tri2[to] = L.tri[row]
        c = frame.dense_center[None, :]
        boxes = chunk_slices((frame.dense_chunk_lo - c).contiguous(),
                             (frame.dense_chunk_hi - c).contiguous()).contiguous()
        tied = sub(pick)
        got, _c, ref2, _ms, _n = k5_hold(f"{scene} {kind} ties across slices",
                                         tied + (coef2, tri2, L.s_group, find_any),
                                         dict(slices=boxes), True)
        rep["tie_lanes"] = int(pick.numel())
        rep["tie_lanes_winner_moved"] = int((ref2[1] != ref[1][pick]).sum())
        rep["tie_lanes_winner_earlier_slice"] = int(
            ((ref2[1] // 32) < (ref[1][pick] // 32)).sum())
    log(f"kernel wavefront_assigned edge holds {scene} {kind}: {json.dumps(rep)}")
    return rep


def plain_schedule(*args, tree=None, tests=None):
    """`schedule_plain` in the place of the schedule wrapper (which also
    takes the kernel's tree and its counter)."""
    from low_precision_raytracer_tpu_torch.ops import wavefront as WF

    return WF.schedule_plain(*args)


def plain_assigned(*args, slices=None, counts=None):
    """`assigned_test_plain` in the place of K5's wrapper (which also takes
    the kernel's slice boxes and its counter)."""
    from low_precision_raytracer_tpu_torch.ops import wavefront as WF

    return WF.assigned_test_plain(*args)


SCHED_DEEP_CHECK = 1 << 18  # rays of a first pass held with a 128-deep list


def schedule_holds(scene, kind, args, kw):
    """The schedule kernel on one recorded wavefront launch: each call the
    launch makes (the first pass, every tail pass) held bit for bit
    against `schedule_plain` on every ray; a 128-deep list from the first
    pass's cursor (the rescan: 8 batches) on SCHED_DEEP_CHECK strided rays;
    the first pass timed, the plain version timed on it, and the boxes the
    walk tests counted by the kernel's counting form: the bound from that
    count, and from the flat scan's (one slab test per live ray and group
    per batch) beside it.  -> report."""
    import torch

    from low_precision_raytracer_tpu_torch.ops import wavefront as WF

    calls = []
    sched = WF.schedule

    def rec(*a, **k):  # the launch updates its cursors in place: keep copies
        out = sched(*a, **k)
        calls.append((tuple(x.clone() if torch.is_tensor(x) else x for x in a), k, out))
        return out

    WF.schedule = rec
    try:
        WF.trace_rays_wavefront(*args, **kw)
    finally:
        WF.schedule = sched
    torch.cuda.synchronize()
    passes = []
    for a, k, (cand, tcut) in calls:
        want = WF.schedule_plain(*a, slab_elems=1 << 26)
        for name, x, y in (("cand", cand, want[0]), ("tcut", tcut, want[1])):
            if not torch.equal(x, y):
                raise AssertionError(f"wavefront_schedule {scene} {kind}: k={a[7]} {name} "
                                     f"differs from the plain version on "
                                     f"{int((x != y).any(dim=-1).sum()) if x.dim() > 1 else int((x != y).sum())} "
                                     f"of {a[2].shape[0]} rays")
        passes.append(dict(rays=int(a[2].shape[0]), k=int(a[7]), checked_rays=int(a[2].shape[0]),
                           zero_axis_rays=int((a[3] == 0).any(dim=1).sum())))
    a, k, (cand, tcut) = calls[0]
    lo, hi, o, d, maxd, wmin, id_bits, kk = a
    R, NG = o.shape[0], lo.shape[0]
    sel = torch.arange(0, R, max(1, R // SCHED_DEEP_CHECK), device=o.device)[:SCHED_DEEP_CHECK]
    deep = (lo, hi, o[sel], d[sel], maxd[sel], tcut[sel].contiguous(), id_bits, min(128, NG))
    got, want = WF.schedule(*deep, tree=k["tree"]), WF.schedule_plain(*deep)
    if not all(torch.equal(x, y) for x, y in zip(got, want)):
        raise AssertionError(f"wavefront_schedule {scene} {kind}: the {deep[7]}-deep list "
                             "differs from the plain version")
    ms = cuda_ms(lambda: WF.schedule(*a, **k), 5)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    WF.schedule_plain(*a, slab_elems=1 << 26)
    e1.record()
    e1.synchronize()
    tests = torch.zeros((R,), dtype=torch.int32, device=o.device)
    WF.schedule(*a, **k, tests=tests)
    n_live = int((maxd > 0).sum())
    batches = kk // 17 + 1
    n_tests = float(tests.double().sum())
    n_flat = float(n_live) * NG * batches
    n_bytes = nbytes(o, d, maxd, wmin, k["tree"].boxes, cand, tcut)
    b_ms, b_by = bound_ms(n_bytes, n_tests * BOX_TEST_OPS)
    b_flat = bound_ms(n_bytes, n_flat * BOX_TEST_OPS)[0]
    rep = dict(scene=scene, kind=kind, rays=R, live=n_live, groups=NG,
               tree_levels=list(k["tree"].sizes), k=kk, ms=ms, plain_ms=e0.elapsed_time(e1),
               bound_ms=b_ms, bound_by=b_by, bound_ms_flat=b_flat, box_tests=n_tests,
               box_tests_flat=n_flat, box_tests_per_live_ray=n_tests / max(n_live, 1),
               ratio=ms / b_ms, ratio_flat=ms / b_flat, max_abs_err=0.0,
               prev_ms=PREV_LAUNCH_MS.get((scene + " schedule", kind)),
               deep_list_checked_rays=int(sel.numel()), passes=passes)
    log(f"kernel wavefront_schedule {scene}: {json.dumps(rep)}")
    return rep


def wavefront_phase(kind, args, kw):
    """One recorded wavefront launch: the schedule kernel, K5 and the whole
    launch held against their plain versions (exact), and the launch timed
    whole and by part.  -> report dict."""
    import torch

    from low_precision_raytracer_tpu_torch.ops import trace as T
    from low_precision_raytracer_tpu_torch.ops import wavefront as WF
    from low_precision_raytracer_tpu_torch.ops.dense_trace import (
        dense_trace_multi,
        dense_trace_multi_sorted,
    )

    frame, origins, directions = args
    find_any = kw["find_any"]
    R = origins.shape[0]
    dev = origins.device
    rep = dict(kind=kind, rays=R, find_any=find_any)

    # the whole launch, each pass timed with events
    passes = []
    pair_pass = WF.pair_pass

    def timed_pass(L, sel, emin, kk):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        res = pair_pass(L, sel, emin, kk)
        e1.record()
        passes.append((R if sel is None else int(sel.numel()), kk, e0, e1))
        return res

    out = WF.trace_rays_wavefront(*args, **kw)
    WF.pair_pass = timed_pass
    try:
        WF.trace_rays_wavefront(*args, **kw)
    finally:
        WF.pair_pass = pair_pass
    torch.cuda.synchronize()
    rep["passes"] = [dict(rays=n, k=kk, ms=e0.elapsed_time(e1)) for n, kk, e0, e1 in passes]
    rep["ms"] = cuda_ms(lambda: WF.trace_rays_wavefront(*args, **kw), 3)
    rep["hits"] = int((out[3] >= 0).sum())

    # the first pass, part by part
    L = WF.setup(frame, origins, directions, kw["prec"], kw["skip_tri"], kw["min_dist"],
                 kw["max_dist"], find_any)
    rep["live"] = int(L.live.sum())
    NG = L.lo.shape[0]
    k = min(WF.ONESHOT_K, NG)
    wmin = torch.full((R,), WF.INT32_MIN, dtype=torch.int32, device=dev)
    mx = torch.where(L.live, L.maxd, 0.0).contiguous()
    sched = lambda: WF.schedule(L.lo, L.hi, L.o, L.d, mx, wmin, L.id_bits, k)
    cand, tcut = sched()
    pair, lanes = WF.pair_lanes(L, None, cand, L.live)
    out5 = WF.assigned_test(*lanes, L.coef, L.tri, L.s_group, find_any, slices=L.slices)
    rep["pairs"] = cand.numel()
    rep["pair_lanes"] = lanes[0].shape[0]  # the live pairs: the lanes K5 tests

    # K5 on every call of the launch, each lane against its plain version
    # (`k5_holds`: the first call is the first pass), and its edge cases
    # (`k5_edge_holds`)
    rep["k5_calls"] = k5_holds("colonnade-83k", kind, args, kw, lights=2 if find_any else 1)
    rep["k5"] = {x: rep["k5_calls"][0][x] for x in (
        "ms", "beside_ms", "plain_ms", "bound_ms", "bound_by", "bound_ms_all_rows",
        "max_abs_err", "checked_lanes")}
    rep["k5_edge"] = k5_edge_holds("colonnade-83k", kind, args, kw)
    parts = dict(
        setup=cuda_ms(lambda: WF.setup(frame, origins, directions, kw["prec"], kw["skip_tri"],
                                       kw["min_dist"], kw["max_dist"], find_any), 3),
        pair_sort=cuda_ms(lambda: WF.pair_lanes(L, None, cand, L.live), 3),
        k5=rep["k5"]["ms"],
        combine=cuda_ms(lambda: WF.combine(pair, out5, cand, tcut, L.id_bits), 5))
    parts["tail"] = sum(p["ms"] for p in rep["passes"][1:])

    # the schedule kernel: every pass held against its plain version, timed
    # and counted (`schedule_holds`)
    rep["schedule"] = schedule_holds("colonnade-83k", kind, args, kw)
    parts["schedule"] = rep["schedule"]["ms"]
    rep["parts_ms"] = parts
    rsel = torch.arange(0, R, max(1, R // BIG_CHECK), device=dev)[:BIG_CHECK]

    # the whole launch on a slice of rays against the same launch through
    # the plain versions
    sub_args = (frame, origins[rsel], directions[rsel])
    sub_kw = dict(kw, skip_tri=kw["skip_tri"][rsel], min_dist=kw["min_dist"][rsel],
                  max_dist=kw["max_dist"][rsel])
    got = WF.trace_rays_wavefront(*sub_args, **sub_kw)
    kern = WF.schedule, WF.assigned_test
    WF.schedule, WF.assigned_test = plain_schedule, plain_assigned
    try:
        want = WF.trace_rays_wavefront(*sub_args, **sub_kw)
    finally:
        WF.schedule, WF.assigned_test = kern
    for name, a, b in zip(("t", "u", "v", "tri", "obj"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"wavefront {kind}: the launch's {name} differs from its "
                                 f"plain route on {int((a != b).sum())} of {rsel.numel()} rays")

    # the same rays through K1b, anchor-sorted and unsorted
    c = frame.dense_center
    TI = frame.dense_n_f32.shape[0]
    k1b_args = ((origins.float() - c[None, :]).contiguous(), directions.float().contiguous(),
                kw["skip_tri"].contiguous(), kw["min_dist"].contiguous(),
                kw["max_dist"].contiguous(), L.coef, frame.dense_tri, frame.dense_obj,
                (frame.dense_chunk_lo - c[None, :]).contiguous(),
                (frame.dense_chunk_hi - c[None, :]).contiguous())
    k1b_kw = dict(find_any=find_any, tree=T._chunk_tables(frame)[2],
                  slices=T._slice_table(frame))
    ref = dense_trace_multi(*k1b_args, **k1b_kw)
    rep["k1b_unsorted_ms"] = cuda_ms(lambda: dense_trace_multi(*k1b_args, **k1b_kw), 1)
    rep["k1b_sorted_ms"] = cuda_ms(lambda: dense_trace_multi_sorted(*k1b_args, **k1b_kw), 1)
    rep["agreement_with_k1b"] = float(((out[3] >= 0) == (ref[3] >= 0)).float().mean()
                                      if find_any else (out[3] == ref[3]).float().mean())
    log(f"wavefront {kind}: {json.dumps(rep)}")
    return rep


def k6_beside_k1b(kind, args, kw, leaves):
    """K6 on one of K1b's colonnade-83k launches (the JAX package sends
    them to K1b): equal to K1b's result (every output), both timed."""
    import torch

    from low_precision_raytracer_tpu_torch.ops.dense_trace import dense_trace_multi
    from low_precision_raytracer_tpu_torch.ops.packet_trace import packet_trace

    lo, hi, tree = leaves
    find_any = kw.get("find_any", False)
    k6 = lambda: packet_trace(*args[:8], lo, hi, find_any=find_any, tree=tree)
    want = dense_trace_multi(*args, **kw)
    got = k6()
    torch.cuda.synchronize()
    for name, a, b in zip(("t", "u", "v", "tri", "obj"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"packet_trace colonnade-83k {kind}: {name} differs from K1b "
                                 f"on {int((a != b).sum())} of {a.numel()} rays")
    rec = dict(kind=kind, rays=int(args[0].shape[0]), k6_ms=cuda_ms(k6, 3),
               k1b_ms=cuda_ms(lambda: dense_trace_multi(*args, **kw), 3), equal=True)
    log(f"kernel packet_trace colonnade-83k beside K1b: {json.dumps(rec)}")
    return rec


# ---------------------------------------------------------------------------
# colonnade-2M: the packet BVH walk (K6)


def colonnade_2m():
    from low_precision_raytracer_tpu_torch.models.procedural import sponza_like_scene

    return sponza_like_scene(10, 5)


def capture_packet_launches(renderer, frames):
    """Render `frames` frames; -> the last frame's K6 launches, in order
    [(kind, args, kwargs, unsorted_args | None)]: primary, round-0
    shadows, GI bounce (sorted), round-1 shadows (sorted).  For a sorted
    launch `args` are the kernel's (sorted) inputs and `unsorted_args` the
    rays as the sorted launch received them."""
    from low_precision_raytracer_tpu_torch.ops import packet_trace as PT
    from low_precision_raytracer_tpu_torch.ops import trace

    calls, sorted_calls = [], []
    orig, orig_sorted = PT.packet_trace, trace.packet_trace_sorted

    def rec(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)

    def rec_sorted(*args, **kw):
        sorted_calls.append((args, kw))
        return orig_sorted(*args, **kw)

    try:
        PT.packet_trace = trace.packet_trace = rec
        trace.packet_trace_sorted = rec_sorted
        for _ in range(frames):
            calls.clear()
            sorted_calls.clear()
            renderer.render()
    finally:
        PT.packet_trace = trace.packet_trace = orig
        trace.packet_trace_sorted = orig_sorted
    kinds = ("primary", "shadow0", "gi_sorted", "shadow1_sorted")
    got = [kw.get("find_any", False) for _a, kw in calls]
    if got != [False, True, False, True] or len(sorted_calls) != 2:
        raise AssertionError(f"colonnade-2M frame: K6 launches (find_any) {got}, "
                             f"{len(sorted_calls)} sorted; want 4, 2 sorted")
    unsorted = [None, None, sorted_calls[0][0], sorted_calls[1][0]]
    return [(k, a, kw, u) for k, (a, kw), u in zip(kinds, calls, unsorted)]


def _pair_entry(b, o, d, maxd, exact0=False):
    """The kernels' slab test of rays (n, 3) against one box each (n, 6):
    -> (entry, ok) (n,); `exact0`: K6's rule, also exact on a zero
    direction axis (`wavefront.slice_entry`, K5's test of its slices)."""
    from low_precision_raytracer_tpu_torch.ops.wavefront import slice_entry

    e, ok_exact0, ok = slice_entry(b, o, 1.0 / d, maxd)
    return e, (ok_exact0 if exact0 else ok)


def first_accepts(args, band, rays, step=256, slab_elems=1 << 24):
    """Index of the first table row that accepts each of `rays` (n,) under
    `band`, -1 where none: the plain version's per-row accept, in blocks
    of `step` rows, a ray dropping out at its first accepted row."""
    import torch

    from low_precision_raytracer_tpu_torch.ops.dense_trace import _accept, tri_quantities

    o, d, skip, mind, maxd, coef, tri_ids = args[:7]
    TI = coef.shape[0]
    first = torch.full((rays.numel(),), -1, dtype=torch.int64, device=o.device)
    todo = torch.arange(rays.numel(), device=o.device)
    for k0 in range(0, TI, step):
        k1 = min(TI, k0 + step)
        for s0 in range(0, todo.numel(), max(1, slab_elems // (k1 - k0))):
            idx = todo[s0:s0 + max(1, slab_elems // (k1 - k0))]
            r = rays[idx]
            t, _u, _v, geom = tri_quantities(coef[k0:k1], o[r], d[r], band)
            acc = _accept(t, geom, skip[r], mind[r], maxd[r], tri_ids[k0:k1])
            hit = acc.any(1)
            first[idx[hit]] = k0 + acc[hit].to(torch.int8).argmax(1)
        todo = todo[first[todo] < 0]
        if todo.numel() == 0:
            break
    return first


def walk_ops(args, t_final, tree, band=None, blocked=None, slices=None, exact0=False,
             scan=False, block=1 << 17, growth=None):
    """Tree-walk operations (K1b, K6) this run's data needs: per live ray,
    one slab test per tree box (internal node or leaf) it enters no later
    than `t_final` (its closest hit, or 1e5), through ancestors it also
    enters so, and the row test (with the band's when there is one) per row
    of each such leaf; with `slices` (K1b's (4 NC, 6) 32-row slice boxes)
    a slab test per slice of each such leaf and the row test per row of
    the slices it enters no later than `t_final`.  `exact0`: boxes are
    entered by K6's rule (exact on a zero direction axis), else by the slab
    test alone (`box_entry`).  Under a widened band the walks grow each
    box for the ray that tests it: `growth` (`walk_growth`) grows them as
    the kernel does at the ray's final best t (`band_pad.grow`).  Counted level
    by level from the root, in blocks of rays.  `scan`: the all-row scan's
    count instead (`band_scan`, the walks' reference on the card): each
    live ray tests the rows in order, all of them, or in an any-hit launch
    (`blocked`, the kernel's result (R,)) a blocked ray up to and including
    its first accepted row.  `block`: rays a block (fewer where each ray
    enters thousands of boxes).  -> (ops, boxes entered, rows tested,
    slices (with `slices`) or leaves entered per ray (R,), 0 for a dead
    ray)."""
    import torch

    from low_precision_raytracer_tpu_torch.ops import band_pad
    from low_precision_raytracer_tpu_torch.ops.dense_trace import FAN

    o, d, _skip, mind, maxd, coef = args[:6]
    TI = coef.shape[0]
    live = torch.nonzero(maxd > mind)[:, 0]
    per_ray = torch.zeros(o.shape[0], dtype=torch.float32, device=o.device)
    if scan:
        n_rows = live.numel() * TI
        if blocked is not None:
            hit = torch.nonzero(blocked)[:, 0]
            first = first_accepts(args, band, hit)
            if bool((first < 0).any()):
                raise AssertionError(f"{int((first < 0).sum())} blocked rays accept no row "
                                     "in the plain per-row test")
            n_rows -= int((TI - 1 - first).sum())
        return float(n_rows) * row_ops(band), 0, n_rows, per_ray
    L = len(tree.sizes)
    offs = tree.levels[:L].tolist()
    n_boxes = n_rows = 0
    for r0 in range(0, live.numel(), block):
        ray = live[r0:r0 + block]
        node = torch.zeros_like(ray)
        for lvl in range(L - 1, -1, -1):
            if lvl < L - 1:
                ch = node[:, None] * FAN + torch.arange(FAN, device=ray.device)[None, :]
                ok = ch < tree.sizes[lvl]
                ray, node = ray[:, None].expand(-1, FAN)[ok], ch[ok]
            b = tree.boxes[offs[lvl] + node]
            if growth is not None:
                b = band_pad.grow(b, growth[0].tree[offs[lvl] + node], growth[1][ray],
                                  growth[2][ray], o[ray], d[ray])
            e, ok = _pair_entry(b, o[ray], d[ray], maxd[ray], exact0)
            keep = ok & (e <= t_final[ray])
            ray, node = ray[keep], node[keep]
            n_boxes += int(keep.sum())
        if slices is None:
            per_ray.index_add_(0, ray, torch.ones_like(ray, dtype=torch.float32))
            n_rows += int(torch.clamp(TI - node * tree.leaf, max=tree.leaf).sum())
            continue
        per = tree.leaf // 32
        sl = node[:, None] * per + torch.arange(per, device=ray.device)[None, :]
        has = sl * 32 < TI
        ray, sl = ray[:, None].expand(-1, per)[has], sl[has]
        n_boxes += sl.numel()
        b = slices[sl]
        if growth is not None:
            b = band_pad.grow(b, growth[0].slices[sl], growth[1][ray], growth[2][ray], o[ray],
                              d[ray])
        e, ok = _pair_entry(b, o[ray], d[ray], maxd[ray], exact0)
        keep = ok & (e <= t_final[ray])
        sl = sl[keep]
        per_ray.index_add_(0, ray[keep], torch.ones_like(sl, dtype=torch.float32))
        n_rows += int(torch.clamp(TI - sl * 32, max=32).sum())
    return (float(n_boxes) * BOX_TEST_OPS + float(n_rows) * row_ops(band), n_boxes, n_rows,
            per_ray)


def walk_growth(args, kw, tree, t_final, slices=None):
    """How a widened band's walk grows the boxes it reads on one launch, for
    `walk_ops`: (the table's pads, the launch's `kw["pads"]` when the
    wrapper was given them, else `band_pads` of `tree` and K1b's `slices`;
    the rays' pads; the |t| each ray's boxes are grown to at its final best
    t `t_final`, or at its reach in any hit and under pack)."""
    from low_precision_raytracer_tpu_torch.ops import band_pad

    o, d, _skip, mind, maxd, coef = args[:6]
    band = kw["band"]
    pads = kw.get("pads") or band_pad.band_pads(coef, band, tree, slices)
    ray4 = band_pad.ray_pads(o, d, mind, maxd, band, tree.boxes[0], pads.root)
    fixed = kw.get("find_any", False) or kw.get("pack", False)
    return pads, ray4, band_pad.pad_t(ray4, mind, t_final, fixed)


def scan_hold(what, out, args, kw, n_rays=None):
    """A widened band's walk (`out`, the launch's result) held bit for bit
    against the all-row scan kernel (`band_scan`) on every ray, or on a
    strided slice of `n_rays`; both timed on those rays (the walk through
    `launch`, re-run on the slice).  -> report fields."""
    import torch

    from low_precision_raytracer_tpu_torch.ops.dense_trace import band_scan

    R = args[0].shape[0]
    dev = args[0].device
    sel = None if n_rays is None or n_rays >= R else \
        torch.arange(0, R, max(1, R // n_rays), device=dev)[:n_rays]
    sub = list(args[:8]) if sel is None else \
        [a[sel].contiguous() for a in args[:5]] + list(args[5:8])
    skw = dict(find_any=kw.get("find_any", False), band=kw["band"], pack=kw.get("pack", False))
    ref = band_scan(*sub, **skw)
    torch.cuda.synchronize()
    for name, a, b in zip(out_names(out), out, ref):
        a = a if sel is None else a[sel]
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: the walk's {name} differs from the all-row scan on "
                                 f"{int((a != b).sum())} of {b.numel()} rays")
    return dict(scan_checked_rays=int(sub[0].shape[0]),
                scan_ms=cuda_ms(lambda: band_scan(*sub, **skw), 1))


def _quantiles(x):
    """[p50, p90, p99, max] of a 1-d tensor (empty: [])."""
    import torch

    if x.numel() == 0:
        return []
    q = torch.tensor([0.5, 0.9, 0.99], device=x.device)
    return [float(v) for v in torch.quantile(x.float(), q)] + [float(x.max())]


def leaf_split(d, live, per_old, per_new, lights, ray, R):
    """Boxes entered (K6: leaves per live ray; K5: slices per lane), p50,
    p90, p99 and max, under box_entry (`per_old`) and the zero-axis rule
    (`per_new`), split by the exact zero direction components of `d` (by
    axis, and none) and, for a shadow launch of R rays laid out lane-major
    over `lights` lights, by the light of each item's ray `ray` (light 0
    the sun).  -> dict."""
    zero = d == 0
    groups = {"all": live, "x0": live & zero[:, 0], "y0": live & zero[:, 1],
              "z0": live & zero[:, 2], "no_zero": live & ~zero.any(dim=1)}
    if lights > 1:
        light = ray // (R // lights)
        for li in range(lights):
            on = live & (light == li)
            groups[f"light{li}"] = on
            groups[f"light{li}_no_zero"] = on & ~zero.any(dim=1)
            groups[f"light{li}_x0"] = on & zero[:, 0]
    return {name: dict(n=int(m.sum()), box_entry=_quantiles(per_old[m]),
                       exact0=_quantiles(per_new[m])) for name, m in groups.items()}


def face_rays(args, leaves, n, seed=0):
    """`n` rays of the launch `args` (strided), each turned to have one
    exact zero direction component and its origin exactly on a face of a
    random leaf in the plane of that face (inside the leaf's span on the
    other axes), the edge case of K6's zero-axis rule.  -> the launch's
    arguments on those rays."""
    import torch

    o, d, skip, mind, maxd = args[:5]
    lo, hi, tree = leaves
    n0 = tree.sizes[0]
    g = torch.Generator(device="cpu").manual_seed(seed)
    R = o.shape[0]
    sel = torch.arange(0, R, max(1, R // n), device=o.device)[:n]
    m = sel.numel()
    leaf = torch.randint(0, n0, (m,), generator=g).to(o.device)
    ax = torch.randint(0, 3, (m,), generator=g).to(o.device)
    side = torch.rand((m,), generator=g).to(o.device) < 0.5
    frac = torch.rand((m, 3), generator=g).to(o.device)
    llo, lhi = lo[leaf], hi[leaf]
    oo = llo + frac * (lhi - llo)
    idx = torch.arange(m, device=o.device)
    oo[idx, ax] = torch.where(side, llo[idx, ax], lhi[idx, ax])
    dd = d[sel].clone()
    dd[idx, ax] = 0.0
    dd = dd / torch.linalg.norm(dd, dim=1, keepdim=True).clamp(min=1e-30)
    bad = ~torch.isfinite(dd).all(dim=1) | (dd.abs().sum(dim=1) == 0)
    dd[bad] = torch.tensor([0.0, 1.0, 0.0], device=o.device)
    mx = torch.where(maxd[sel] > mind[sel], maxd[sel], 40.0)
    return [oo.contiguous(), dd.contiguous(), skip[sel].contiguous(), mind[sel].contiguous(),
            mx.contiguous()] + list(args[5:])


def k6_phase(launches, leaves, scene="colonnade-2M", chunks=None, check_rays=PACKET_CHECK,
             lights=1, scan_rays=None, scan_bound=True, count_rays=None, reps=5,
             full_timing=True):
    """K6 on each recorded launch: timed on the full launch in both
    persistences (the wrapper persists in any hit), held against the plain
    version on `check_rays` rays (a strided slice; with `chunks` also the
    launch's `check_rays // 16` rays with the most leaves under box_entry,
    and a launch of face rays, `face_rays`), every output exact; with
    `chunks` (K1b's chunk boxes, tree and slice boxes of the same table)
    also held equal to K1b on every ray, both timed, and the leaves entered
    per ray measured under both box rules (`leaf_split`).  Its bound from
    the data under the kernel's rule (`walk_ops`), the old rule's count
    beside it.  The sorted launches also unsorted, and their key and sort +
    unsort on their own.  Under a widened band the walk grows each box for
    its ray: the bound and the leaves entered per ray count those,
    the unpadded boxes' count and the all-row scan's beside them, and the
    walk is held bit for bit against the scan kernel on every ray (or a
    strided slice of `scan_rays`; `scan_bound=False`: without the scan's
    count).  `check_rays=0`: no plain hold.  `count_rays`: the bound and
    the leaves per ray counted on a strided slice of that many rays (a
    band's grown boxes on colonnade-2M: hundreds of leaves a ray), held
    beside the walk timed on the same slice.  `reps`: timed calls a launch;
    `full_timing=False` leaves out the other persistence, the slice and
    the sorted launches' unsorted, key and sort timings.  -> report."""
    import torch

    from low_precision_raytracer_tpu_torch.ops.dense_trace import (
        dense_trace_multi,
        dense_trace_multi_plain,
    )
    from low_precision_raytracer_tpu_torch.ops.packet_trace import (
        morton_key,
        packet_trace,
        packet_trace_sorted,
    )

    _lo, _hi, tree = leaves
    per = []
    for kind, args, kw, unsorted in launches:
        R = args[0].shape[0]
        dev = args[0].device
        find_any = kw.get("find_any", False)
        band = kw["band"]
        out = packet_trace(*args, **kw)
        torch.cuda.synchronize()
        rec = dict(kind=kind, rays=R, live=int((args[4] > args[3]).sum()),
                   hits=int((out[3] >= 0).sum()))
        # the bound, and the leaves entered per ray under both rules, on the
        # rays in the launch's lane-major order (a sorted launch: as the sort
        # received them); any-hit rays need the boxes up to their closest
        # blocker
        margs = list(unsorted if unsorted is not None else args)
        t_final = packet_trace(*margs, **dict(kw, find_any=False))[0]
        if find_any:
            m_out = packet_trace(*margs, **kw)
            t_final = torch.where(m_out[3] >= 0, t_final, 1e5)
        blocked = (out[3] >= 0) if find_any else None
        m_blocked = (m_out[3] >= 0) if find_any else None
        blk = 1 << 17
        if count_rays is not None:  # the counts on a strided slice of the rays
            csel = torch.arange(0, R, max(1, R // count_rays), device=dev)[:count_rays]
            margs = [a[csel].contiguous() for a in margs[:5]] + list(margs[5:])
            t_final = t_final[csel]
            m_blocked = None if m_blocked is None else m_blocked[csel]
            blk = 1 << 10
        growth = walk_growth(margs, kw, tree, t_final) if band.widened else None
        n_ops, n_boxes, n_rows, per_new = walk_ops(margs, t_final, tree, band,
                                                   blocked=m_blocked, exact0=True, block=blk,
                                                   growth=growth)
        o_ops, o_boxes, o_rows, per_old = walk_ops(margs, t_final, tree, band,
                                                   blocked=m_blocked, block=blk, growth=growth)
        n_bytes = nbytes(*margs[:10], tree.boxes) + nbytes(*out) * margs[0].shape[0] // R
        if growth is not None:  # the pads the walk reads
            n_bytes += nbytes(growth[0].tree, growth[1])
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        live = margs[4] > margs[3]
        if count_rays is not None:  # the walk on the rays counted
            rec.update(counted_rays=int(margs[0].shape[0]), counted_ms=cuda_ms(
                lambda: packet_trace(*margs[:8], *args[8:10], **kw), 3))
        rec.update(bound_ms=b_ms, bound_by=b_by, bytes=n_bytes, ops=n_ops, boxes_entered=n_boxes,
                   rows_tested=n_rows, bound_ms_box_entry=bound_ms(n_bytes, o_ops)[0],
                   boxes_entered_box_entry=o_boxes, rows_tested_box_entry=o_rows,
                   leaves_per_live_ray=_quantiles(per_new[live]),
                   leaves_per_live_ray_box_entry=_quantiles(per_old[live]))
        if band.widened:  # beside: the unpadded boxes' count, the all-row scan
            u_ops, _b, u_rows, u_per = walk_ops(margs, t_final, tree, band, blocked=m_blocked,
                                                exact0=True, block=blk)
            rec.update(leaves_per_live_ray_unpadded=_quantiles(u_per[live]),
                       rows_tested_unpadded=u_rows, bound_ms_unpadded=bound_ms(n_bytes, u_ops)[0])
            if scan_bound:
                s_ops = walk_ops(margs, t_final, tree, band, blocked=m_blocked, scan=True)[0]
                rec["bound_ms_scan"] = bound_ms(n_bytes, s_ops)[0]
            rec.update(scan_hold(f"packet_trace {scene} {kind}", out, args, kw, scan_rays))
        if chunks is not None:
            rec["leaf_split"] = leaf_split(margs[1], live, per_old, per_new,
                                           lights if find_any else 1,
                                           torch.arange(R, device=dev), R)

        # the plain version on the sample
        sel = torch.arange(0, R, max(1, R // max(1, check_rays)), device=dev)[:check_rays]
        if chunks is not None:  # ... with the rays entering the most leaves (box_entry)
            per_old_k = per_old
            if unsorted is not None:  # in the kernel's order: the sort's permutation
                o, d, mn, mx = unsorted[0], unsorted[1], unsorted[3], unsorted[4]
                per_old_k = per_old[torch.sort(morton_key(o, d, live=mx > mn),
                                               stable=True).indices]
            top = torch.topk(per_old_k, check_rays // 16).indices
            sel = torch.unique(torch.cat([sel[:check_rays - top.numel()], top]))
        sub = [a[sel].contiguous() for a in args[:5]] + list(args[5:8])
        plain_ms, err = None, 0.0
        if check_rays:
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            ref = dense_trace_multi_plain(*sub, find_any=find_any, band=band,
                                          slab_elems=1 << 27)
            t1.record()
            t1.synchronize()
            plain_ms = t0.elapsed_time(t1)
            for name, a, b in zip(("t", "u", "v", "tri", "obj"), out, ref):
                a = a[sel]
                if not torch.equal(a, b):
                    raise AssertionError(f"packet_trace {scene} {kind}: {name} differs from "
                                         f"the plain version on {int((a != b).sum())} of "
                                         f"{sel.numel()} rays")
                if a.dtype == torch.float32:
                    err = max(err, float((a - b).abs().max()))
            del ref
        zero_sel = int((sub[1] == 0).any(dim=1).sum())
        rec.update(plain_ms=plain_ms, plain_ms_on="sample", checked_rays=int(sel.numel()),
                   checked_zero_axis_rays=zero_sel, max_abs_err=err)
        if chunks is not None:
            # face rays: one exact zero axis, the origin on a leaf face
            fargs = face_rays(args, leaves, 1024, seed=len(per))
            fout = packet_trace(*fargs, **kw)
            fref = dense_trace_multi_plain(*fargs[:8], find_any=find_any, band=band,
                                           slab_elems=1 << 27)
            if not all(torch.equal(a, b) for a, b in zip(fout, fref)):
                raise AssertionError(f"packet_trace {scene} {kind}: face rays differ from the "
                                     "plain version")
            rec["face_rays_checked"] = int(fargs[0].shape[0])
            rec["face_rays_hits"] = int((fout[3] >= 0).sum())
            # K1b on every ray of the launch, the same table
            c_lo, c_hi, c_tree, c_slices = chunks
            k1b = lambda: dense_trace_multi(*args[:8], c_lo, c_hi, find_any=find_any, band=band,
                                            tree=c_tree, slices=c_slices)
            want = k1b()
            torch.cuda.synchronize()
            for name, a, b in zip(("t", "u", "v", "tri", "obj"), out, want):
                if not torch.equal(a, b):
                    raise AssertionError(f"packet_trace {scene} {kind}: {name} differs from K1b "
                                         f"on {int((a != b).sum())} of {R} rays")
            del want
            rec["equal_to_k1b_rays"] = R
            rec["k1b_ms"] = cuda_ms(k1b, 3)
        ms = cuda_ms(lambda: packet_trace(*args, **kw), reps)
        rec.update(ms=ms, prev_ms=PREV_LAUNCH_MS.get((scene, kind)))
        rec["ratio"] = rec.get("counted_ms", ms) / b_ms
        if full_timing:
            other = not find_any  # the wrapper persists in any hit
            rec.update(other_persist=other, other_persist_ms=cuda_ms(
                lambda: packet_trace(*args, **dict(kw, persist=other)), reps),
                slice_ms=cuda_ms(lambda: packet_trace(*sub, *args[8:10], **kw), reps))
        if unsorted is not None:
            srt = packet_trace_sorted(*unsorted, **kw)
            direct = packet_trace(*unsorted, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(srt, direct)):
                raise AssertionError(f"packet_trace {kind}: sorted launch differs from the "
                                     "unsorted one")
        if unsorted is not None and full_timing:
            o, d, mn, mx = unsorted[0], unsorted[1], unsorted[3], unsorted[4]
            key = morton_key(o, d, live=mx > mn)
            rec["unsorted_ms"] = cuda_ms(lambda: packet_trace(*unsorted, **kw), 5)
            rec["sorted_total_ms"] = cuda_ms(lambda: packet_trace_sorted(*unsorted, **kw), 5)
            rec["key_ms"] = cuda_ms(lambda: morton_key(o, d, live=mx > mn), 5)
            rec["sort_ms"] = cuda_ms(lambda: torch.sort(key, stable=True), 5)
            rec["sort_unsort_ms"] = rec["sorted_total_ms"] - ms
        per.append(rec)
        log(f"kernel packet_trace {scene}: {json.dumps(rec)}")
    mean = lambda k: statistics.fmean(p[k] for p in per) if per[0].get(k) is not None else None
    log(f"kernel packet_trace {scene}: mean ms {mean('ms')} over {len(per)} launches "
        f"(before: {PREV_MEAN_MS.get(scene)})")
    return dict(max_abs_err=max(p["max_abs_err"] for p in per), ms=mean("ms"),
                plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
                bound_by=max(per, key=lambda p: p["bound_ms"])["bound_by"],
                scan_ms=mean("scan_ms"), launches=per)


# ---------------------------------------------------------------------------
# the two-level BVH walk (traversal_impl='jax'; ops/traversal.py,
# csrc/bvh_walk.cu)

WALK_CHECK = 1024  # colonnade-8M: rays of each held slice
WALK_CHECK_SMALL = 1 << 15  # Cornell, colonnade-5k: rays of each held slice
# colonnade-8M's held rays are a strided sample of those whose walk takes
# at most this many steps: the plain loop steps every held lane together,
# ~9 ms an iteration on the card, and a sun ray of colonnade-8M takes up
# to ~70,000 steps; the share of rays under the cap is printed.  The long
# zero-axis walks are held on colonnade-5k, uncapped (its longest ~1,500
# steps), its slices joined by each kind's WALK_CHECK_SMALL // 16 longest
WALK_CAP = 1024
# per step a slab test (BOX_TEST_OPS); per triangle the dtype test's f32
# operations: O 3, the x / y rows 20, Oz / Dz 10, t 3, t Dx / t Dy 2, u v
# 2, the four error sums 32, error_u / error_v 14, w 2, compares 12 (the
# f32 re-test inside the band not counted); per object entered the
# transform 40
WALK_TRI_OPS = 100
WALK_ENTER_OPS = 40
# what a walk with no cache would read: a node's box and links (24 + 20
# bytes) per step, a triangle's id and dtype row (4 + 48) per test
WALK_NODE_BYTES = 44
WALK_TRI_BYTES = 52


def colonnade_8m():
    from low_precision_raytracer_tpu_torch.models.procedural import sponza_like_scene

    return sponza_like_scene(10, 6)


def capture_walk_launches(renderer, frames):
    """Render `frames` frames; -> the last frame's walk launches in order,
    [(args, kwargs)] of `ops/traversal.py:trace_rays`."""
    from low_precision_raytracer_tpu_torch.ops import trace

    calls = []
    orig = trace.trace_rays

    def rec(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)

    try:
        trace.trace_rays = rec
        for _ in range(frames):
            calls.clear()
            renderer.render()
    finally:
        trace.trace_rays = orig
    return list(calls)


def walk_slices(renderer, launches):
    """The held kinds of a frame's walk launches (the routes that never
    reorder: the primary, round 0's shadows and GI bounce as one
    closest-hit launch of L + 1 lanes a pixel, lane-major, round 1's
    shadows): -> [(kind, launch index, first ray, end ray)]."""
    R = renderer.cfg.width * renderer.cfg.height
    L = launches[2][0][2].shape[0] // R
    kinds = [("primary", 0, 0, R), ("shadow0", 1, 0, L * R), ("gi", 1, L * R, (L + 1) * R),
             ("shadow1", 2, 0, L * R)]
    got = [kw.get("find_any", False) for _a, kw in launches]
    if got != [False, False, True] or launches[1][0][2].shape[0] != (L + 1) * R:
        raise AssertionError(f"walk launches (find_any) {got}, want primary, round 0 "
                             "(L + 1 lanes), round 1 shadows")
    return kinds


def walk_counts(st, live, order=None):
    """A walk launch's per-ray counts (R, N_STATS) read: -> (steps per ray
    (double), a record of the sums, the steps per live ray, and the warps'
    efficiency, the share of a warp's lane-steps that walk, the steps a warp
    of 32 consecutively launched rays runs being its longest ray's;
    `order`: the launched rays in launch order, else every ray in the
    caller's)."""
    import torch

    steps = (st[:, 0] + st[:, 1]).double()
    launched = steps if order is None else steps[order]
    pad = (-launched.numel()) % 32
    warps = torch.nn.functional.pad(launched, (0, pad)).view(-1, 32)
    n_steps = float(steps.sum())
    return steps, dict(
        steps=n_steps, tri_tests=float(st[:, 2].double().sum()),
        objects_entered=float(st[:, 3].double().sum()),
        warp_efficiency=n_steps / max(1.0, 32 * float(warps.max(dim=1).values.sum())),
        steps_per_live_ray=_quantiles(steps[live].float()),
        mean_steps_per_live_ray=float(steps[live].mean()) if live.any() else 0.0)


def walk_bound(counts, tables, ray_bytes):
    """The bound from a walk's counts: the slab tests, triangle tests and
    transforms over f32 peak, the rays, the outputs and the tables once
    over HBM."""
    n_ops = (counts["steps"] * BOX_TEST_OPS + counts["tri_tests"] * WALK_TRI_OPS
             + counts["objects_entered"] * WALK_ENTER_OPS)
    return bound_ms(tables + ray_bytes, n_ops)


def walk_sorted(args, kw):
    """The walk (`trace_rays`) on a launch's rays sorted by `morton_key` in
    its 'beam' mode (dead rays last; a stable sort) and its results
    scattered back, as `sorted_launch` sorts K1b's: the sort lever, on no
    render path."""
    import torch

    from low_precision_raytracer_tpu_torch.ops.dense_trace import morton_key
    from low_precision_raytracer_tpu_torch.ops.traversal import _rays, trace_rays

    o, d, skip, mind, maxd = _rays(args[2], args[3], kw.get("skip_tri"), kw["min_dist"],
                                   kw["max_dist"], kw["prec"].dtype)
    order = torch.sort(morton_key(o, d, live=maxd > mind, mode="beam"), stable=True).indices
    outs = trace_rays(args[0], args[1], o[order], d[order],
                      **{**kw, "skip_tri": skip[order], "min_dist": mind[order],
                         "max_dist": maxd[order]})
    back = []
    for x in outs:
        y = torch.empty_like(x)
        y[order] = x
        back.append(y)
    return back


def walk_phase(scene, renderer, launches, check=WALK_CHECK, reps=3, cap=WALK_CAP, top=0,
               plain=True):
    """The walk on each recorded launch beside its reference, its first
    form (`trace_rays_reference`: the JAX machine, one thread a ray in the
    caller's order, no rule): both timed in turns (a b b a, CUDA events),
    on an incoherent launch (whose live rays the walk packs) with the walk
    in place (`coherent=True`), the walk on the rays sorted
    (`walk_sorted`, held bit for bit too) and the packing's `launch_order`
    alone, so each lever's cost and gain show; their
    per-ray counts read (steps p50 / p90 / p99 / max per live ray, triangle
    tests, objects entered, the warps' efficiency on each one's launched
    order, the live rays split by an exact zero direction component; the
    walk's dead rays count 0), the bound from each one's counts; the walk
    held bit for bit (t, u, v bits, ids) against the reference on every
    ray.  The reference is held bit for bit (t, u, v, ids and the counts)
    against the plain version on each kind's slice of `check` rays (a
    strided sample of the rays its counts take at most `cap` steps, all
    rays when `cap` is None, joined by the kind's `top` longest walks and
    its `top` longest walks of rays with an exact zero direction axis), the
    kinds of one launch in one plain call (`plain_ms`: the mean of those
    calls); the walk is held against the same plain results too.  Each
    held slice prints its largest step count beside the kind's.  `plain=False`: no hold against the plain version (the
    whole-launch hold against the reference only).  -> (the walk's report,
    the reference's)."""
    import torch

    from low_precision_raytracer_tpu_torch.ops.traversal import (
        N_STATS,
        _rays,
        launch_order,
        trace_rays,
        trace_rays_plain,
        trace_rays_reference,
    )

    per, held, plains = [], [], []
    kinds = walk_slices(renderer, launches)
    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
    for i, (args, kw) in enumerate(launches):
        scene_t, frame = args[0], args[1]
        R = args[2].shape[0]
        dev = args[2].device
        coherent = kw.get("coherent", True)
        rkw = {k: v for k, v in kw.items() if k != "coherent"}
        st_ref = torch.zeros((R, N_STATS), dtype=torch.int32, device=dev)
        st = torch.full((R, N_STATS), -1, dtype=torch.int32, device=dev)
        ref = trace_rays_reference(*args, **rkw, stats=st_ref)
        out = trace_rays(*args, **kw, stats=st)
        torch.cuda.synchronize()
        for name, x, y in zip(("t", "u", "v", "tri", "obj"), out, ref):
            if not torch.equal(bits(x), bits(y)):
                n_bad = int((bits(x) != bits(y)).sum())
                raise AssertionError(f"bvh_walk {scene} launch {i}: {name} differs from the "
                                     f"reference walk on {n_bad} of {R} rays")
        tables = nbytes(*(getattr(scene_t, k) for k in (
            "blas_lo", "blas_hi", "blas_parent", "blas_lc", "blas_rc", "blas_leaf_offset",
            "blas_leaf_count", "blas_prim", "blas_root", "tri_v2", "tri_m", "tri_v2_f32",
            "tri_m_f32")), frame.obj_w2l, frame.obj_mesh, frame.tlas_lo, frame.tlas_hi,
            frame.tlas_parent)
        ray_bytes = R * (3 * 4 * 2 + 4 + 4 + 4) + nbytes(*out)
        prec = kw["prec"]
        o_w, d_w, _skip, mind, maxd = _rays(args[2], args[3], kw.get("skip_tri"),
                                            kw["min_dist"], kw["max_dist"], prec.dtype)
        order = None if coherent else launch_order(mind, maxd).long()
        live = maxd > mind
        steps_ref, c_ref = walk_counts(st_ref, live)
        steps, c_new = walk_counts(st, live, order)
        b_ms, b_by = walk_bound(c_new, tables, ray_bytes)
        rb_ms, rb_by = walk_bound(c_ref, tables, ray_bytes)
        fns = [lambda: trace_rays(*args, **kw), lambda: trace_rays_reference(*args, **rkw)]
        if not coherent:
            for name, x, y in zip(("t", "u", "v", "tri", "obj"), walk_sorted(args, kw), ref):
                if not torch.equal(bits(x), bits(y)):
                    raise AssertionError(f"bvh_walk {scene} launch {i}, sorted: {name} "
                                         "differs from the reference walk")
            fns += [lambda: trace_rays(*args, **{**kw, "coherent": True}),
                    lambda: walk_sorted(args, kw), lambda: launch_order(mind, maxd)]
        samples = [statistics.fmean(x) for x in ab_ms(fns, reps, rounds=1)]
        ms, ref_ms = samples[0], samples[1]
        levers = {} if coherent else dict(in_place_ms=samples[2], sorted_ms=samples[3],
                                          launch_order_ms=samples[4])
        zero = (args[3] == 0).any(dim=1) & live
        split = lambda sts, stp: {
            name: dict(rays=int(m.sum()), mean_steps=float(stp[m].mean()),
                       mean_objects_entered=float(sts[m, 3].double().mean()))
            for name, m in (("zero_axis", zero), ("other", live & ~zero)) if m.any()}
        rec = dict(launch=i, rays=R, live=int(live.sum()), coherent=coherent,
                   hits=int((out[3] >= 0).sum()), find_any=kw.get("find_any", False),
                   ms=ms, ref_ms=ref_ms, speedup=ref_ms / ms, **levers,
                   bound_ms=b_ms, bound_by=b_by,
                   ratio=ms / b_ms, ref_bound_ms=rb_ms, ref_bound_by=rb_by, **c_new,
                   live_rays_by_direction=split(st, steps),
                   dead_rays_count_zero=bool((st[~live] == 0).all()),
                   ref={**c_ref, "live_rays_by_direction": split(st_ref, steps_ref)},
                   cacheless_bytes_ms=(c_new["steps"] * WALK_NODE_BYTES
                                       + c_new["tri_tests"] * WALK_TRI_BYTES) / HBM_BPS * 1e3,
                   held_against_reference="every ray", max_abs_err=0.0)
        if not rec["dead_rays_count_zero"]:
            raise AssertionError(f"bvh_walk {scene} launch {i}: a dead ray has counts")
        per.append(rec)
        log(f"kernel bvh_walk {scene} launch {i}: {json.dumps(rec)}")
        if not plain:
            continue
        mine = [(kind, a, b) for kind, li, a, b in kinds if li == i]
        sels, tops = [], []
        for _kind, a, b in mine:
            rng = torch.arange(a, b, device=dev)
            ok = rng if cap is None else rng[steps_ref[a:b] <= cap]
            sel = ok[torch.arange(0, ok.numel(), max(1, ok.numel() // check),
                                  device=dev)[:check - 2 * top]]
            n_zero = int(zero[a:b].sum())
            if top:
                # the kind's longest walks, and its longest zero-axis walks
                longest = a + torch.topk(steps_ref[a:b], top).indices
                zs = torch.where(zero[a:b], steps_ref[a:b], -1.0)
                longest_zero = a + torch.topk(zs, min(top, n_zero)).indices
                sel = torch.unique(torch.cat([sel, longest, longest_zero]))
                tops.append((top, min(top, n_zero)))
            else:
                tops.append((0, 0))
            sels.append(sel)
        # one plain call holds every kind of the launch: it takes as many
        # iterations as its longest held walk has steps, whatever the lanes
        sel = torch.cat(sels)
        pick = lambda x: x[sel] if torch.is_tensor(x) and x.dim() > 0 else x
        pkw = {k: pick(v) for k, v in rkw.items()}
        pst = torch.zeros((sel.numel(), N_STATS), dtype=torch.int32, device=dev)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        plain_out = trace_rays_plain(scene_t, frame, args[2][sel], args[3][sel], **pkw,
                                     stats=pst)
        e1.record()
        e1.synchronize()
        plain_ms = e0.elapsed_time(e1)
        plains.append(plain_ms)
        n0 = 0
        for (kind, a, b), ks, (n_top, n_top_zero) in zip(mine, sels, tops):
            part = slice(n0, n0 + ks.numel())
            n0 += ks.numel()
            for name, x, y in zip(("t", "u", "v", "tri", "obj", "counts"), (*ref, st_ref),
                                  (*plain_out, pst)):
                if not torch.equal(bits(x[ks]), bits(y[part])):
                    raise AssertionError(f"bvh_walk_ref {scene} {kind}: {name} differs from "
                                         "the plain version")
            for name, x, y in zip(("t", "u", "v", "tri", "obj"), out, plain_out):
                if not torch.equal(bits(x[ks]), bits(y[part])):
                    raise AssertionError(f"bvh_walk {scene} {kind}: {name} differs from the "
                                         "plain version")
            held_steps = pst[part, 0] + pst[part, 1]
            held_zero = (args[3][ks] == 0).any(dim=1)
            h = dict(kind=kind, rays=b - a, held=int(ks.numel()), cap=cap,
                     longest_held=n_top, longest_zero_axis_held=n_top_zero,
                     share_under_cap=1.0 if cap is None else
                     float((steps_ref[a:b] <= cap).float().mean()),
                     plain_ms_launch=plain_ms,
                     max_held_steps=int(held_steps.max()) if ks.numel() else 0,
                     max_steps=int(steps_ref[a:b].max()),
                     held_zero_axis=int(held_zero.sum()),
                     max_held_steps_zero_axis=int(held_steps[held_zero].max())
                     if held_zero.any() else 0,
                     steps_per_live_ray_ref=_quantiles(steps_ref[a:b][live[a:b]].float()),
                     steps_per_live_ray=_quantiles(steps[a:b][live[a:b]].float()),
                     zero_axis_rays=int((args[3][a:b] == 0).any(dim=1).sum()))
            if top and h["max_held_steps"] != h["max_steps"]:
                raise AssertionError(f"bvh_walk_ref {scene} {kind}: the longest walk was not "
                                     "held")
            held.append(h)
            log(f"kernel bvh_walk {scene} {kind} held: {json.dumps(h)}")
    mean = lambda k: statistics.fmean(p[k] for p in per)
    walk = dict(max_abs_err=0.0, ms=mean("ms"),
                plain_ms=statistics.fmean(plains) if plains else None,
                bound_ms=mean("bound_ms"),
                bound_by=max(per, key=lambda p: p["bound_ms"])["bound_by"],
                ref_ms=mean("ref_ms"), ref_bound_ms=mean("ref_bound_ms"), launches=per,
                held=held)
    ref = dict(max_abs_err=0.0, ms=mean("ref_ms"), plain_ms=walk["plain_ms"],
               bound_ms=mean("ref_bound_ms"),
               bound_by=max(per, key=lambda p: p["ref_bound_ms"])["ref_bound_by"])
    log(f"kernel bvh_walk {scene} summary: " + json.dumps(dict(
        ms=[p["ms"] for p in per], ref_ms=[p["ref_ms"] for p in per],
        in_place_ms=[p.get("in_place_ms") for p in per],
        sorted_ms=[p.get("sorted_ms") for p in per],
        launch_order_ms=[p.get("launch_order_ms") for p in per],
        bound_ms=[p["bound_ms"] for p in per], ref_bound_ms=[p["ref_bound_ms"] for p in per],
        plain_ms=walk["plain_ms"])))
    return walk, ref


def walk_kernel_phase():
    """colonnade-8M (bf16, 1080p): the Renderer's host build (the BLAS by
    the native builder, the first TLAS), then the walk held on the
    launches of a warm frame (`walk_phase`);
    colonnade-2M under traversal_impl='jax', the walk against its reference
    on every ray; colonnade-5k under traversal_impl='jax' (bf16, 1080p),
    held with no step cap; Cornell under traversal_impl='jax' in bf16,
    fp16 and fp32, 'both' and 'dtype', held on every kind of its launches.
    -> colonnade-8M's reports (the walk's, the reference's)."""
    import torch

    from low_precision_raytracer_tpu_torch.config import RenderConfig
    from low_precision_raytracer_tpu_torch.models import scene as S
    from low_precision_raytracer_tpu_torch.models.procedural import (
        cornell_box_scene,
        sponza_like_scene,
    )
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer

    t0 = time.perf_counter()
    warm = Renderer(colonnade_8m(), RenderConfig(width=W, height=H, precision="bf16"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if warm.cfg.traversal_impl != "jax" or warm.frame.dense_n is not None:
        raise AssertionError(f"colonnade-8M resolved to {warm.cfg.traversal_impl!r}")
    log(f"colonnade-8M: {S.instance_tris(warm.frame)} instance triangles in "
        f"{len(warm.frame.obj_layout)} objects, {warm.scene.tri_v2.shape[0]} triangles on the "
        f"host, {warm.scene.blas_parent.shape[0]} BLAS nodes, "
        f"{warm.frame.tlas_parent.shape[0]} TLAS nodes; host seconds: Renderer {build_s:.3f} "
        f"(BLAS build, native {S.HOST_SECONDS['blas']:.4f}; first TLAS build "
        f"{S.HOST_SECONDS['tlas']:.6f})")
    launches = capture_walk_launches(warm, 2)
    report, ref_report = walk_phase("colonnade-8M", warm, launches, reps=2)
    del warm, launches
    torch.cuda.empty_cache()
    # colonnade-2M on the walk: every ray against the reference (its path
    # phase ran before)
    r = Renderer(colonnade_2m(), RenderConfig(width=W, height=H, precision="bf16",
                                              traversal_impl="jax"))
    walk_phase("colonnade-2M", r, capture_walk_launches(r, 2), reps=2, plain=False)
    del r
    torch.cuda.empty_cache()
    # the long zero-axis walks (the sun's rays enter every box their y and
    # z slabs cross), uncapped, on colonnade-5k
    r = Renderer(sponza_like_scene(), RenderConfig(width=W, height=H, precision="bf16",
                                                   traversal_impl="jax"))
    walk_phase("colonnade-5k", r, capture_walk_launches(r, 2), check=WALK_CHECK_SMALL, cap=None,
               top=WALK_CHECK_SMALL // 16)
    del r
    for precision in ("bf16", "fp16", "fp32"):
        for fallback in ("both", "dtype"):
            r = Renderer(cornell_box_scene(), RenderConfig(
                width=W, height=H, precision=precision, traversal_impl="jax",
                triangle_fallback=fallback))
            walk_phase(f"cornell-{precision}-{fallback}", r, capture_walk_launches(r, 1),
                       check=WALK_CHECK_SMALL, reps=3)
            del r
    torch.cuda.empty_cache()
    return report, ref_report


def colonnade_328k():
    from low_precision_raytracer_tpu_torch.models.procedural import sponza_like_scene

    return sponza_like_scene(8, 4)


def colonnade_328k_kernel_phase(cfg):
    """K1b on colonnade-328k's primary and round-0 shadow launches (2,567
    chunks), held to the plain version on a strided slice of BIG_CHECK rays
    (primary) and of SHADOW_328K_CHECK rays (the shadows); the schedule kernel on its
    two wavefront launches (`schedule_holds`), and K5 (s_group = 2) on
    every call they make (`k5_holds`) and its edge cases
    (`k5_edge_holds`).  -> (K1b report, schedule reports)."""
    import torch

    from low_precision_raytracer_tpu_torch.ops import trace as T
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer

    warm = Renderer(colonnade_328k(), cfg)
    if warm.cfg.traversal_impl != "dense_pallas":
        raise AssertionError(f"colonnade-328k resolved to {warm.cfg.traversal_impl!r}")
    calls = capture_big_launches(warm, 2)
    tree = T._chunk_tables(warm.frame)[2]
    log(f"colonnade-328k: {T.instance_tris(warm.frame)} instance triangles, "
        f"{warm.frame.dense_chunk_lo.shape[0]} chunks, chunk tree levels {tree.sizes}")
    del warm
    rep = k1b_phase([(kind, a, kw, None) for kind, (_n, a, kw)
                     in zip(("primary", "shadow0"), calls[:2])],
                    check_rays=BIG_CHECK, reps=3, plain_on_slice=True, scene="colonnade-328k",
                    check_by_kind={"shadow0": SHADOW_328K_CHECK})
    sched = [schedule_holds("colonnade-328k", kind, a, kw)
             for kind, (_n, a, kw) in zip(("gi", "shadow1"), calls[2:])]
    k5 = []
    for kind, (_n, a, kw) in zip(("gi", "shadow1"), calls[2:]):
        k5 += k5_holds("colonnade-328k", kind, a, kw, lights=2 if kw["find_any"] else 1)
        k5_edge_holds("colonnade-328k", kind, a, kw)
    log("colonnade-328k K5 (ms, beside ms, bound ms, all-row bound ms) per call: " + json.dumps(
        [dict(kind=r["kind"], call=r["call"], lanes=r["lanes"], ms=r["ms"],
              ms_spread=r["ms_spread"], beside_ms=r["beside_ms"],
              beside_spread=r["beside_spread"], bound_ms=r["bound_ms"],
              bound_ms_all_rows=r["bound_ms_all_rows"]) for r in k5]))
    del calls
    torch.cuda.empty_cache()
    return rep, sched


def colonnade_kernel_phase(cfg):
    """Phase 9.  -> (K1b report, {wavefront_assigned, wavefront_schedule}
    reports)."""
    import torch

    from low_precision_raytracer_tpu_torch.render.renderer import Renderer

    from low_precision_raytracer_tpu_torch.ops import trace as T

    warm = Renderer(colonnade_83k(), cfg)
    calls = capture_big_launches(warm, 2)
    leaves = T._packet_tables(warm.frame)
    del warm
    k1b = k1b_phase([(kind, a, kw, None) for kind, (_n, a, kw)
                               in zip(("primary", "shadow0"), calls[:2])],
                              check_rays=BIG_CHECK, reps=3, plain_on_slice=True,
                              scene="colonnade-83k")
    k1b["k6_beside_k1b"] = [k6_beside_k1b(kind, a, kw, leaves) for kind, (_n, a, kw)
                            in zip(("primary", "shadow0"), calls[:2])]
    wf = [wavefront_phase(kind, a, kw) for kind, (_n, a, kw) in zip(("gi", "shadow1"), calls[2:])]
    del calls
    torch.cuda.empty_cache()
    mean = lambda part, k: statistics.fmean(r[part][k] for r in wf)
    reports = {}
    for name, part in (("wavefront_assigned", "k5"), ("wavefront_schedule", "schedule")):
        reports[name] = dict(max_abs_err=max(r[part]["max_abs_err"] for r in wf),
                             ms=mean(part, "ms"), plain_ms=mean(part, "plain_ms"),
                             bound_ms=mean(part, "bound_ms"),
                             bound_by=max(wf, key=lambda r: r[part]["bound_ms"])[part]["bound_by"])
    return k1b, reports


# ---------------------------------------------------------------------------
# the packed epilogue, the wavefront's 'rounds' mode, the Q2.4 tool


def assigned_ops_q(lanes, out, TI, NG, s_group, find_any):
    """K5 operations this run's data needs with q groups a lane: the rows
    of each of its groups in order (ids outside [0, NG) test nothing); an
    any-hit lane up to its first accepted row."""
    import torch

    from low_precision_raytracer_tpu_torch.ops.dense_trace import CHUNK

    gid = lanes[5].long()
    span = s_group * CHUNK
    valid = (gid >= 0) & (gid < NG)
    rows = torch.where(valid, torch.clamp(TI - gid * span, min=0, max=span), 0)
    if find_any:
        row = out[1].long()
        hit = row >= 0
        at = valid & (gid == (row // span)[:, None]) & hit[:, None]
        first = torch.where(at.any(1), at.to(torch.int8).argmax(1), gid.shape[1])
        before = torch.arange(gid.shape[1], device=gid.device)[None, :] < first[:, None]
        rows = torch.where(hit[:, None], torch.where(before, rows, 0), rows)
        extra = torch.where(hit, row - (row // span) * span + 1, 0)
        return float(rows.double().sum() + extra.double().sum()) * TRI_TEST_OPS
    return float(rows.double().sum()) * TRI_TEST_OPS


def rounds_phase(kind, args, kw):
    """One recorded wavefront launch in 'rounds' mode: its K5 launches
    (q = Q_RANKS lanes in the rounds, q = 1 in the tail passes) through
    `k5_holds` (every lane exact, timed with their bounds); the whole
    launch on a slice of rays against its plain route (exact); rounds,
    cycles and tail rays; the launch timed against 'oneshot' on the same
    rays.  -> report dict."""
    import torch

    from low_precision_raytracer_tpu_torch.ops import wavefront as WF

    frame, origins, directions = args
    find_any = kw["find_any"]
    R = origins.shape[0]
    dev = origins.device
    WF.reset_stats()
    out = WF.trace_rays_wavefront(*args, **kw)
    torch.cuda.synchronize()
    rep = dict(kind=kind, rays=R, find_any=find_any, stats=dict(WF.STATS),
               hits=int((out[3] >= 0).sum()))
    k5 = k5_holds("colonnade-83k rounds", kind, args, kw, lights=2 if find_any else 1)
    if not any(r["q"] == WF.Q_RANKS for r in k5):
        raise AssertionError(f"rounds {kind}: no K5 launch with q = {WF.Q_RANKS}")
    rep["k5"] = k5
    rep["rounds_ms"] = cuda_ms(lambda: WF.trace_rays_wavefront(*args, **kw), 3)
    one = dict(kw, mode="oneshot")
    rep["oneshot_ms"] = cuda_ms(lambda: WF.trace_rays_wavefront(*args, **one), 3)
    ref1 = WF.trace_rays_wavefront(*args, **one)
    rep["hit_agreement_with_oneshot"] = float(((out[3] >= 0) == (ref1[3] >= 0)).float().mean())

    # the whole launch on a slice of rays against the plain route
    rsel = torch.arange(0, R, max(1, R // BIG_CHECK), device=dev)[:BIG_CHECK]
    sub_args = (frame, origins[rsel], directions[rsel])
    sub_kw = dict(kw, skip_tri=kw["skip_tri"][rsel], min_dist=kw["min_dist"][rsel],
                  max_dist=kw["max_dist"][rsel])
    got = WF.trace_rays_wavefront(*sub_args, **sub_kw)
    kern = WF.schedule, WF.assigned_test
    WF.schedule, WF.assigned_test = plain_schedule, plain_assigned
    try:
        want = WF.trace_rays_wavefront(*sub_args, **sub_kw)
    finally:
        WF.schedule, WF.assigned_test = kern
    for name, x, y in zip(("t", "u", "v", "tri", "obj"), got, want):
        if not torch.equal(x, y):
            raise AssertionError(f"wavefront rounds {kind}: the launch's {name} differs from "
                                 f"its plain route on {int((x != y).sum())} of {rsel.numel()} rays")
    log(f"wavefront rounds {kind}: {json.dumps(rep)}")
    return rep


def pack_phases(run_path, counts):
    """The packed epilogue (dense_epilogue='pack', bf16): K1a on the
    flagship's two closest-hit launches (every ray) and K1b on the
    Sponza-class frame's two (2^18-ray slices), each held bit for bit and
    timed beside the full epilogue on the same rays; then 4 frames of each
    path with the launch sequence held.  -> {name: report}, the path
    launch totals."""
    import torch

    from low_precision_raytracer_tpu_torch.config import RenderConfig
    from low_precision_raytracer_tpu_torch.models.procedural import (
        cornell_box_scene,
        sponza_like_scene,
    )
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer

    cfg = RenderConfig(width=W, height=H, precision="bf16", dense_epilogue="pack")
    warm = Renderer(cornell_box_scene(), cfg)
    calls = capture_inputs(warm, 2)
    del warm
    if [kw.get("pack") for _a, kw, _o in calls.get("dense_trace", [])] != [True, True]:
        raise AssertionError("flagship pack: want two closest-hit K1a launches in the packed "
                             "form and no fused shadow phase")
    reports = kernel_phase(calls, names=("dense_trace",), tag=" pack")
    reports["dense_trace_pack"] = reports.pop("dense_trace")
    del calls
    # per frame: K1a packed twice (the primary; round 0's shadows and GI
    # bounce in one launch), round 1's shadows on K1b's any hit, no fused DI
    run_path("flagship-pack", cornell_box_scene,
             counts(dense_trace_pack=2, dense_trace_multi=1), frames_n=4,
             dense_epilogue="pack")
    warm = Renderer(sponza_like_scene(), cfg)
    launches = capture_sponza_launches(warm, 2)
    del warm
    closest = [x for x in launches if not x[2].get("find_any")]
    if [x[2].get("pack") for x in closest] != [True, True]:
        raise AssertionError("sponza pack: the closest-hit launches are not packed")
    reports["dense_trace_multi_pack"] = k1b_phase(closest, reps=5, plain_on_slice=True,
                                                  scene="sponza pack")
    del launches, closest
    torch.cuda.empty_cache()
    run_path("sponza-pack", sponza_like_scene,
             counts(dense_trace_multi_pack=2, dense_trace_multi=2), frames_n=4,
             dense_epilogue="pack")
    return reports


def rounds_kernel_phase():
    """colonnade-83k (bf16) with wavefront_mode='rounds': its two wavefront
    launches of one warm-up frame through `rounds_phase`."""
    import torch

    from low_precision_raytracer_tpu_torch.config import RenderConfig
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer

    warm = Renderer(colonnade_83k(), RenderConfig(width=W, height=H, precision="bf16",
                                                  wavefront_mode="rounds"))
    calls = capture_big_launches(warm, 2)
    del warm
    reps = []
    for kind, (_n, a, kw) in zip(("gi", "shadow1"), calls[2:]):
        if kw.get("mode") != "rounds":
            raise AssertionError(f"colonnade-83k rounds {kind}: launched in {kw.get('mode')!r}")
        reps.append(rounds_phase(kind, a, kw))
    del calls
    torch.cuda.empty_cache()
    return reps


def tool_phase(nchunk, tc=48):
    """The Q2.4 tool (`tools/mxu_proto.py`) at 1080p, `nchunk` chunks of
    `tc` rows: its own run (`measure`: both bodies timed, their agreement)
    with the launch counts zeroed just before; then each body against its
    plain version on a 2^16-ray slice (the VPU body bit for bit, the MXU
    body to its bar), the plain versions timed there, the bounds from the
    code's operation counts.  -> ({name: report}, launches)."""
    import torch

    from low_precision_raytracer_tpu_torch.ops import cuda_lib
    from low_precision_raytracer_tpu_torch.tools import mxu_proto as MP

    case = MP.make_case(nchunk, tc, MP.R_1080P, "cuda")
    cuda_lib.reset_launches()
    rep = MP.measure(nchunk, tc, case=case)
    launches = {k: cuda_lib.LAUNCHES[k] for k in ("mxu_proto_vpu", "mxu_proto_mxu")}
    if min(launches.values()) == 0:
        raise AssertionError(f"mxu_proto NCHUNK={nchunk}: launches {launches}")
    R = case["o"].shape[1]
    sel = torch.arange(0, R, max(1, R // BIG_CHECK), device="cuda")[:BIG_CHECK]
    sub = dict(case, o=case["o"][:, sel].contiguous(), d=case["d"][:, sel].contiguous())
    bodies = {
        "mxu_proto_vpu": (MP.run_vpu, lambda c: MP.vpu_body_plain(
            c["n_dt"], c["n_f32"], c["e"], c["o"], c["d"], c["tc"])),
        "mxu_proto_mxu": (MP.run_mxu, lambda c: MP.mxu_body_plain(
            c["a32t"], c["aabt"], c["o"], c["d"], c["tc"])),
    }
    pairs = R * nchunk * tc
    in_bytes = nbytes(case["o"], case["d"])
    reports = {}
    for name, (kern, plain) in bodies.items():
        got = kern(sub)
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        want = plain(sub)
        e1.record()
        e1.synchronize()
        hit_k, hit_p = got[0] < 1e5, want[0] < 1e5
        agree = float((hit_k == hit_p).float().mean())
        both = hit_k & hit_p
        dev_rel = max(float(((a - b).abs() / (1e-5 * b.abs() + 1e-6))[both].max())
                      if bool(both.any()) else 0.0 for a, b in zip(got, want))
        err = max(float((a - b)[both].abs().max()) if bool(both.any()) else 0.0
                  for a, b in zip(got, want))
        if name == "mxu_proto_vpu":
            for n, a, b in zip("tuv", got, want):
                if not torch.equal(a, b):
                    raise AssertionError(f"{name} NCHUNK={nchunk}: {n} differs from the plain "
                                         f"version on {int((a != b).sum())} of {sel.numel()} rays")
            t_ops = pairs * MP.VPU_OPS / F32_FLOPS
            tab = nbytes(case["n_dt"], case["n_f32"], case["e"])
        else:
            # the tensor cores' accumulation order is not the plain version's:
            # hit agreement >= 0.9999, |x - plain| <= 1e-5 |plain| + 1e-6 where both hit
            if agree < 0.9999 or dev_rel > 1.0:
                raise AssertionError(f"{name} NCHUNK={nchunk}: hit agreement {agree}, "
                                     f"deviation {dev_rel} of the bar")
            t_ops = pairs * (MP.MXU_OPS_F32 / F32_FLOPS + MP.MXU_OPS_BF16 / BF16_TC_FLOPS)
            tab = nbytes(case["a32t"], case["aabt"])
        t_bytes = (in_bytes + tab + 3 * R * 4) / HBM_BPS
        key = "vpu_ms" if name == "mxu_proto_vpu" else "mxu_ms"
        reports[name] = dict(ms=rep[key], plain_ms=e0.elapsed_time(e1), plain_ms_on="slice",
                             bound_ms=max(t_ops, t_bytes) * 1e3,
                             bound_by="operations" if t_ops >= t_bytes else "bytes",
                             max_abs_err=err, hit_agreement=agree,
                             deviation_of_bar=dev_rel, checked_rays=int(sel.numel()))
    log(f"tool mxu_proto TC={tc} NCHUNK={nchunk}: {json.dumps(dict(run=rep, **reports))}")
    return reports, launches


BAND_ACCS = (("bf16", "both"), ("bf16", "dtype"), ("fp16", "both"), ("fp16", "dtype"),
             ("fp32", "dtype"))


def band_kernel_phase(precision, fallback):
    """K1a, K1b and K6 under one error-band acceptance (a sub-f32 form, or
    fp32 'dtype'): each held bit for bit
    against its plain version and timed, on the launches of one warm-up
    1080p frame of the flagship (K1a, every ray), of the Sponza-class frame
    (K1b, 2^18-ray slices) and of its packet route (K6 on colonnade-5k with
    traversal_impl='pallas', 4,096-ray slices).  -> {name: report}."""
    import torch

    from low_precision_raytracer_tpu_torch.config import RenderConfig
    from low_precision_raytracer_tpu_torch.models.procedural import (
        cornell_box_scene,
        sponza_like_scene,
    )
    from low_precision_raytracer_tpu_torch.ops import trace as T
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer

    tag = f" {precision}-{fallback}"
    kw = dict(width=W, height=H, precision=precision, triangle_fallback=fallback)
    warm = Renderer(cornell_box_scene(), RenderConfig(**kw))
    calls = capture_inputs(warm, 1)
    del warm
    reports = kernel_phase(calls, names=("dense_trace",), tag=tag)
    del calls
    warm = Renderer(sponza_like_scene(), RenderConfig(**kw))
    launches = capture_sponza_launches(warm, 1)
    del warm
    reports["dense_trace_multi"] = k1b_phase(launches, reps=3, plain_on_slice=True,
                                             scene="sponza" + tag)
    del launches
    warm = Renderer(sponza_like_scene(), RenderConfig(traversal_impl="pallas", **kw))
    launches = capture_packet_launches(warm, 1)
    leaves = T._packet_tables(warm.frame)
    del warm
    reports["packet_trace"] = k6_phase(launches, leaves, scene="colonnade-5k packet route" + tag)
    del launches, leaves
    torch.cuda.empty_cache()
    return reports


BIG_BAND_ACCS = (("colonnade-83k", "bf16", "both"), ("colonnade-83k", "fp16", "dtype"),
                 ("colonnade-2M", "bf16", "both"))


def band_big_kernel_phase(name, precision, fallback):
    """A widened band above the old 8,192-triangle cap, on the launches of
    one warm-up 1080p frame: colonnade-83k on the dense route (K1b, the GI
    bounce and round-1 shadows sorted) with its walk held bit for bit
    against the all-row scan kernel on every ray, or colonnade-2M on the
    packet route (K6) held so on a strided 2^16-ray slice; both timed, the
    slices (K1b) or leaves (K6) entered per live ray under the grown boxes
    beside the unpadded ones (K6: counted on a strided 2^16-ray slice, its
    bound beside the walk timed on that slice).  No plain hold: the scan
    kernel is held against the plain version in `band_kernel_phase`.
    -> report."""
    from low_precision_raytracer_tpu_torch.config import RenderConfig
    from low_precision_raytracer_tpu_torch.ops import trace as T
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer

    packet = name == "colonnade-2M"
    scene_fn = colonnade_2m if packet else colonnade_83k
    tag = f"{name} {precision}-{fallback}"
    warm = Renderer(scene_fn(), RenderConfig(width=W, height=H, precision=precision,
                                             triangle_fallback=fallback))
    want = "pallas" if packet else "dense_pallas"
    if warm.cfg.traversal_impl != want:
        raise AssertionError(f"{tag} resolved to {warm.cfg.traversal_impl!r}, want {want!r}")
    if packet:
        launches = capture_packet_launches(warm, 1)
        leaves = T._packet_tables(warm.frame)
        del warm
        rep = k6_phase(launches, leaves, scene=tag, check_rays=0, scan_rays=1 << 16,
                       scan_bound=False, count_rays=1 << 16, reps=1, full_timing=False)
    else:
        launches = capture_sponza_launches(warm, 1)
        del warm
        rep = k1b_phase(launches, check_rays=0, reps=3, scene=tag, scan_bound=False)
    del launches
    per = "leaves_per_live_ray" if packet else "slices_per_live_ray"
    log(f"band walk {tag} (ms, scan ms, {per} p50/p90/p99/max grown and unpadded): "
        + json.dumps([dict(kind=r["kind"], ms=r["ms"], scan_ms=r["scan_ms"],
                           scan_checked_rays=r["scan_checked_rays"], bound_ms=r["bound_ms"],
                           counted_ms=r.get("counted_ms"), grown=r[per],
                           unpadded=r[per + "_unpadded"]) for r in rep["launches"]]))
    return rep


# ---------------------------------------------------------------------------
# The user entry points (the CLI, checkpoint / resume, the explorer) and the
# last render options


def cli_phase(path_ms):
    """The CLI on the flagship at 1080p bf16, 8 frames with --profile: its
    PNG decodes (utils/png.py) to exactly `to_uint8` of a Renderer(seed=0)'s
    8th frame rendered here; the 12 stage times on one line beside the
    path phase's frame ms; `parity` at 1080p.  -> (launch counts of the
    render command, the parity JSON)."""
    import contextlib
    import io

    import torch

    from low_precision_raytracer_tpu_torch import cli
    from low_precision_raytracer_tpu_torch.config import RenderConfig
    from low_precision_raytracer_tpu_torch.models.procedural import cornell_box_scene
    from low_precision_raytracer_tpu_torch.ops import cuda_lib
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer
    from low_precision_raytracer_tpu_torch.utils.image import to_uint8
    from low_precision_raytracer_tpu_torch.utils.png import decode_png

    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "cornell.png")
        err = io.StringIO()
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main(["render", "cornell", "--width", str(W), "--height", str(H),
                           "--precision", "bf16", "--frames", str(PATH_FRAMES), "--profile",
                           "--out", png])
        wall = time.perf_counter() - t0
        launches = dict(cuda_lib.LAUNCHES)
        if rc != 0:
            raise AssertionError(f"cli render: exit {rc}\n{err.getvalue()}")
        with open(png, "rb") as fh:
            rgba = decode_png(fh.read())
    r = Renderer(cornell_box_scene(), RenderConfig(width=W, height=H, precision="bf16"))
    for f in range(PATH_FRAMES):
        img, _aux = r.render(time=f * (1 / 30))  # the CLI's --time-step
    want = to_uint8(img)[::-1]
    if rgba.shape != (H, W, 4) or not (rgba[..., :3] == want).all():
        diff = int((rgba[..., :3] != want).any(axis=-1).sum()) if rgba.shape == (H, W, 4) \
            else rgba.shape
        raise AssertionError(f"cli render: the PNG differs from the Renderer's frame ({diff})")
    stages = {}
    for line in err.getvalue().splitlines():  # --profile: "<stage>: <ms> ms"
        if line.endswith(" ms") and ":" in line:
            name, val = line.rsplit(":", 1)
            stages[name.strip()] = float(val.split()[0])
    del r, img
    torch.cuda.empty_cache()
    log(f"cli render cornell 1080p bf16 {PATH_FRAMES} frames --profile: exit 0, {wall:.2f} s, "
        f"the PNG equal to the Renderer's frame {PATH_FRAMES}; launches {json.dumps(launches)}")
    log("cli profile stage ms (1080p bf16 flagship): " + json.dumps(
        {**stages, "path_frame_ms": path_ms.get("flagship")}))
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(["parity", "cornell", "--width", str(W), "--height", str(H),
                  "--frames", str(PATH_FRAMES)])
    parity = json.loads(out.getvalue())
    log(f"cli parity cornell 1080p ({time.perf_counter() - t0:.2f} s): {json.dumps(parity)}")
    return launches, parity


def checkpoint_phase():
    """4 flagship frames (1080p bf16), saved; a fresh Renderer (another
    seed) loads the file; frames 5-8 rendered both ways agree bit for bit,
    image and carried state.  -> launch counts of the two runs."""
    import torch

    from low_precision_raytracer_tpu_torch.config import RenderConfig
    from low_precision_raytracer_tpu_torch.models.procedural import cornell_box_scene
    from low_precision_raytracer_tpu_torch.ops import cuda_lib
    from low_precision_raytracer_tpu_torch.render.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer

    cfg = RenderConfig(width=W, height=H, precision="bf16")
    cuda_lib.reset_launches()
    a = Renderer(cornell_box_scene(), cfg)
    for f in range(4):
        a.render()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ck.npz")
        t0 = time.perf_counter()
        save_checkpoint(path, a.state, a.generator, a.frame_index)
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path)
        b = Renderer(cornell_box_scene(), cfg, seed=12345)
        t0 = time.perf_counter()
        b.state, b.generator, b.frame_index = load_checkpoint(path)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    for f in range(4, 8):
        ia, _ = a.render()
        ib, _ = b.render()
        sa, sb = a.state, b.state
        same = torch.equal(ia, ib) and all(torch.equal(x, y) for x, y in zip(
            (*sa.svgf_colored, *sa.svgf_white, sa.taa_history, sa.svgf_frame_count),
            (*sb.svgf_colored, *sb.svgf_white, sb.taa_history, sb.svgf_frame_count)))
        if not same:
            raise AssertionError(f"checkpoint: frame {f + 1} differs after resuming")
    launches = dict(cuda_lib.LAUNCHES)
    if b.frame_index != 8:
        raise AssertionError(f"checkpoint: frame index {b.frame_index}")
    log(f"checkpoint cornell 1080p bf16: saved after frame 4 ({size / 2**20:.3f} MiB, save "
        f"{t_save:.3f} s, load {t_load:.3f} s); frames 5-8 resumed bit for bit (image and "
        f"state); launches {json.dumps(launches)}")
    del a, b
    torch.cuda.empty_cache()
    return launches


EXPLORER_FRAMES = 30


def explorer_phase():
    """`serve` on 127.0.0.1 at a free port in a thread; 30 frames of the
    flagship at 1080p bf16, TAA 0.3, over HTTP with key and mouse events
    moving the camera and one settings round trip; frames/s and ms a frame
    (the client's round trip and the explorer's `render_frame`) beside the
    Renderer's own frame time in this call.  -> launch counts."""
    import threading
    import urllib.request

    import torch

    from low_precision_raytracer_tpu_torch.config import RenderConfig
    from low_precision_raytracer_tpu_torch.gui.viewer import SceneExplorer, serve
    from low_precision_raytracer_tpu_torch.models.procedural import cornell_box_scene
    from low_precision_raytracer_tpu_torch.ops import cuda_lib
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer

    cfg = RenderConfig(width=W, height=H, precision="bf16", taa_mix_weight=0.3)
    # the Renderer alone: its frame time on the same configuration
    r = Renderer(cornell_box_scene(), cfg)
    own = []
    for f in range(10):
        t0 = time.perf_counter()
        r.render()
        torch.cuda.synchronize()
        own.append((time.perf_counter() - t0) * 1e3)
    del r
    cuda_lib.reset_launches()
    ex = SceneExplorer(cornell_box_scene(), cfg)
    srv = serve(ex, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    rt_ms, ex_ms, moved = [], [], None
    try:
        page = urllib.request.urlopen(base + "/", timeout=60).read()
        if b"lprt explorer" not in page:
            raise AssertionError("explorer: the page is missing")
        rig0 = ex.rig.translation.copy()
        for f in range(EXPLORER_FRAMES):
            inp = {"keys": ["w"] if f < 10 else ["d"] if f < 20 else [],
                   "mouse": [10 * f, 5], "right": 20 <= f < 25, "wheel": 0}
            if f == 25:
                inp["settings"] = {"add_gi_white": False}
            if f == 26:
                inp["settings"] = {"add_gi_white": True}
            req = urllib.request.Request(base + "/frame", data=json.dumps(inp).encode(),
                                         method="POST")
            t0 = time.perf_counter()
            resp = urllib.request.urlopen(req, timeout=120)
            body = resp.read()
            rt_ms.append((time.perf_counter() - t0) * 1e3)
            stats = json.loads(resp.headers["x-stats"])
            ex_ms.append(stats["ms"])
            if len(body) != H * W * 3:
                raise AssertionError(f"explorer frame {f}: {len(body)} bytes")
            if any("failed" in m for m in stats["messages"]):
                raise AssertionError(f"explorer frame {f}: {stats['messages']}")
            if f == 25 and stats["settings"]["add_gi_white"] is not False:
                raise AssertionError("explorer: the settings round trip did not apply")
            if f == 26 and stats["settings"]["add_gi_white"] is not True:
                raise AssertionError("explorer: the settings round trip did not return")
        moved = ex.rig.translation - rig0
        if float(abs(moved).sum()) == 0:
            raise AssertionError("explorer: the key events did not move the camera")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    launches = dict(cuda_lib.LAUNCHES)
    steady = rt_ms[5:]
    log(f"explorer cornell 1080p bf16 TAA 0.3 over HTTP, {EXPLORER_FRAMES} frames (median of "
        f"frames 6-{EXPLORER_FRAMES}): {1e3 / statistics.median(steady):.2f} frames/s, "
        f"{statistics.median(steady):.3f} ms a frame round trip, render_frame "
        f"{statistics.median(ex_ms[5:]):.1f} ms; the Renderer alone "
        f"{statistics.median(own[2:]):.3f} ms a frame (median of frames 3-10); host overhead "
        f"{statistics.median(steady) - statistics.median(own[2:]):.3f} ms a frame; the rig "
        f"moved {[round(float(x), 4) for x in moved]}; launches {json.dumps(launches)}")
    del ex
    torch.cuda.empty_cache()
    return launches


SIGMA_N_FLOAT = 127.5
WIDE_STRIDES = (1, 2, 4, 8, 16, 32, 64)


def option_cases():
    """The four options of ROADMAP queue 1 item 9: name -> RenderConfig
    keywords."""
    from low_precision_raytracer_tpu_torch.config import SVGFConfig

    return {"shade_f32=False": dict(shade_f32=False),
            "state_f32=False": dict(svgf=SVGFConfig(state_f32=False)),
            f"sigma_n={SIGMA_N_FLOAT}": dict(svgf=SVGFConfig(sigma_n=SIGMA_N_FLOAT)),
            "strides to 64": dict(svgf=SVGFConfig(strides=WIDE_STRIDES))}


def options_phase(run_path, counts):
    """Each option on the 1080p bf16 flagship: K3 and K4 held against their
    plain versions on the card on a warm-up frame's inputs (K4 bit for bit
    at every stride, the float exponent included; K3 at rtol 1e-4 / atol
    1e-5), timed, then 4 frames of the path with its launches checked (K4
    once a stride).  -> {case: {name: report}} (the per-launch reports
    under "per")."""
    import torch

    from low_precision_raytracer_tpu_torch.config import RenderConfig
    from low_precision_raytracer_tpu_torch.models.procedural import cornell_box_scene
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer

    reports = {}
    for case, kw in option_cases().items():
        warm = Renderer(cornell_box_scene(), RenderConfig(width=W, height=H, precision="bf16",
                                                          **kw))
        calls = capture_inputs(warm, 2)
        del warm
        reports[case] = kernel_phase(calls, names=("temporal_accum", "wavelet_iter"),
                                     tag=f" {case}")
        del calls
        torch.cuda.empty_cache()
        strides = kw["svgf"].strides if "svgf" in kw else (1, 2, 4, 8, 16)
        run_path(f"flagship-{case}", cornell_box_scene,
                 counts(dense_trace=2, wavelet_iter=len(strides)), frames_n=4, **kw)
    return reports


def fallback_lines():
    """The fp32-fallback rate of the band test on Cornell's primary launch
    at 256 x 256 (`ops/diagnostics.py`, the form of `bench.py:fallback_rate`:
    the camera grid in the render dtype), fp16 and bf16."""
    from low_precision_raytracer_tpu_torch.config import get_precision
    from low_precision_raytracer_tpu_torch.models.procedural import cornell_box_scene
    from low_precision_raytracer_tpu_torch.models.scene import flatten_frame
    from low_precision_raytracer_tpu_torch.ops.camera import primary_ray_grid
    from low_precision_raytracer_tpu_torch.ops.diagnostics import fallback_rate

    n = 256
    for name in ("fp16", "bf16"):
        prec = get_precision(name)
        frame = flatten_frame(cornell_box_scene(), prec, "cuda", 4, n, n)
        o, d = primary_ray_grid(frame.cam_l2w_f32, frame.cam_fov_y_f32, n, n, prec.dtype)
        rate = fallback_rate(frame, o.reshape(-1, 3), d.reshape(-1, 3), prec)
        if not 0 < rate["ambiguous"] < rate["tested"]:
            raise AssertionError(f"fallback rate {name}: {rate}")
        log(f"fallback_rate cornell primary {n}x{n} {name}: {json.dumps(rate)}")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    global BESIDE
    if "--beside" in argv:
        BESIDE = load_beside(argv[argv.index("--beside") + 1])
    from low_precision_raytracer_tpu_torch.config import RenderConfig
    from low_precision_raytracer_tpu_torch.models.procedural import (
        cornell_box_scene,
        sponza_like_scene,
    )
    from low_precision_raytracer_tpu_torch.ops import cuda_lib
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    build_logs = cuda_lib.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s ({', '.join(build_logs) or 'cached'})")
    ptxas_report(build_logs)
    cfg = RenderConfig(width=W, height=H, precision="bf16")
    totals = dict.fromkeys(cuda_lib.LAUNCHES, 0)  # launches over every path phase
    # ... by acceptance: "fp32", "fp16" ('auto'), "<precision>-<fallback>"
    group_totals = {}

    path_ms = {}  # the median frame ms of each path phase

    def run_path(name, scene_fn, want_fn, precision="bf16", **kw):
        p_totals, p_frames, p_peak, img, aux = path_phase(cuda_lib, scene_fn, want_fn,
                                                          precision, **kw)
        report_path(name, p_frames, p_peak, p_totals)
        path_ms[name] = statistics.median(f["ms"] for f in (p_frames[2:] or p_frames))
        group = f"{precision}-{kw['triangle_fallback']}" if "triangle_fallback" in kw \
            else precision
        g_totals = group_totals.setdefault(group, dict.fromkeys(cuda_lib.LAUNCHES, 0))
        for k, n in p_totals.items():
            totals[k] += n
            g_totals[k] += n
        torch.cuda.empty_cache()
        return p_totals, img, aux

    def elapsed():
        log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    def counts(**kw):  # per-frame launches: K3 1, K4 5, K2 from frame 1, the rest 0
        base = {"dense_trace": 0, "dense_trace_multi": 0, "temporal_accum": 1,
                "wavelet_iter": 5, "wavefront_schedule": 0, "wavefront_assigned": 0,
                "packet_trace": 0, "dense_trace_pack": 0, "dense_trace_multi_pack": 0,
                "mxu_proto_vpu": 0, "mxu_proto_mxu": 0, "band_scan": 0, "bvh_walk": 0,
                "bvh_walk_ref": 0}
        return lambda f: {**base, "coef_fetch": 1 if f > 0 else 0, **kw}

    # ---- the flagship (Cornell): K1a, K2, K3, K4
    warm = Renderer(cornell_box_scene(), cfg)
    calls = capture_inputs(warm, 2)
    del warm
    reports = kernel_phase(calls)
    del calls
    k4_edge_holds()
    k3_edge_holds()
    k2_edge_holds()
    k1a_edge_holds()
    torch.cuda.empty_cache()
    elapsed()

    flag_totals, flag_img, _aux = run_path("flagship", cornell_box_scene, counts(dense_trace=2))
    for name in ("dense_trace", "coef_fetch", "temporal_accum", "wavelet_iter"):
        if flag_totals[name] == 0:
            raise AssertionError(f"{name}: no launch on the flagship path")

    psnrs, _agree = reference_phase(cornell_box_scene, REF_FRAMES)
    log(f"reference flagship: {REF_SIZE}x{REF_SIZE} card vs plain-on-CPU PSNR dB "
        + " ".join(f"{p:.2f}" for p in psnrs))
    torch.cuda.empty_cache()
    elapsed()

    # ---- the user entry points: the CLI, checkpoint / resume, the explorer
    entry = {"cli": cli_phase(path_ms)[0], "checkpoint": checkpoint_phase(),
             "explorer": explorer_phase()}
    for what, got in entry.items():
        for name in ("dense_trace", "coef_fetch", "temporal_accum", "wavelet_iter"):
            if got[name] == 0:
                raise AssertionError(f"{name}: no launch in the {what} phase")
        for name, n in got.items():
            totals[name] += n
    elapsed()

    # ---- the last render options: K3 and K4 held on each, 4 frames each
    option_reports = options_phase(run_path, counts)
    for case, reps in option_reports.items():
        log(f"options {case}: K4 ms by stride " + json.dumps(
            {p["stride"]: p["ms"] for p in reps["wavelet_iter"]["per"]})
            + f", K3 ms {reps['temporal_accum']['ms']:.4f}, frame ms "
            f"{path_ms[f'flagship-{case}']:.3f} (flagship {path_ms['flagship']:.3f})")
    elapsed()

    # ---- the interactive path: animated Cornell, the camera dollying, TAA 0.3
    animated_kernel_phase(RenderConfig(width=W, height=H, precision="bf16",
                                       taa_mix_weight=0.3))
    run_path("animated", animated_scene, counts(dense_trace=2), motion="objects",
             taa_mix_weight=0.3)
    psnrs, _agree = reference_phase(animated_scene, PATH_FRAMES, moving=True, taa_mix_weight=0.3)
    log(f"reference animated: {REF_SIZE}x{REF_SIZE} card vs plain-on-CPU PSNR dB "
        + " ".join(f"{p:.2f}" for p in psnrs))
    elapsed()

    # ---- the Sponza-class frame: K1b (with K2, K3, K4)
    warm = Renderer(sponza_like_scene(), cfg)
    launches = capture_sponza_launches(warm, 2)
    calls = capture_inputs(warm, 1)
    del warm
    kernel_phase(calls, names=("temporal_accum",), tag=" sponza")
    del calls
    reports["dense_trace_multi"] = k1b_phase(launches)
    k1b_edge_holds(launches)
    del launches
    torch.cuda.empty_cache()
    elapsed()

    run_path("sponza", sponza_like_scene, counts(dense_trace_multi=4))
    psnrs, _agree = reference_phase(sponza_like_scene, SPONZA_REF_FRAMES)
    log(f"reference sponza: {REF_SIZE}x{REF_SIZE} card vs plain-on-CPU PSNR dB "
        + " ".join(f"{p:.2f}" for p in psnrs))
    torch.cuda.empty_cache()
    # the camera turning: the same tables every frame, K1b's launches as still
    run_path("sponza-camera", sponza_camera_scene, counts(dense_trace_multi=4),
             frames_n=CAMERA_FRAMES, motion="camera")
    elapsed()

    # ---- textured glTF scenes: BoxTextured (K1a), the textured Sponza-class .glb (K1b)
    with tempfile.TemporaryDirectory() as tmp:
        textured_phases(run_path, counts, cfg, tmp)
    elapsed()

    # ---- colonnade-83k: K1b at 647 chunks, the wavefront (K5, schedule)
    k1b_big, wf_reports = colonnade_kernel_phase(cfg)
    reports.update(wf_reports)
    elapsed()

    def wavefront_counts(got):
        return got["wavefront_assigned"] >= 2 and \
            got["wavefront_assigned"] == got["wavefront_schedule"]

    big = counts(dense_trace_multi=2, wavefront_schedule=wavefront_counts,
                 wavefront_assigned=wavefront_counts)
    run_path("colonnade-83k", colonnade_83k, big)
    psnrs, _agree = reference_phase(colonnade_83k, SPONZA_REF_FRAMES)
    log(f"reference colonnade-83k: {REF_SIZE}x{REF_SIZE} card vs plain-on-CPU PSNR dB "
        + " ".join(f"{p:.2f}" for p in psnrs))
    log(f"colonnade-83k K1b: {json.dumps(k1b_big)}")
    elapsed()

    # ---- colonnade-2M: the packet BVH walk (K6)
    from low_precision_raytracer_tpu_torch.ops import trace as T

    warm = Renderer(colonnade_2m(), cfg)
    if warm.cfg.traversal_impl != "pallas":
        raise AssertionError(f"colonnade-2M resolved to {warm.cfg.traversal_impl!r}")
    launches = capture_packet_launches(warm, 2)
    leaves = T._packet_tables(warm.frame)
    n0 = leaves[2].sizes[0]
    ext = (warm.frame.dense_leaf_hi - warm.frame.dense_leaf_lo)[:n0].amax(dim=1)
    ext_q = torch.quantile(ext, torch.tensor([0.5, 0.9, 0.99], device=ext.device)).tolist()
    log(f"colonnade-2M: {T.instance_tris(warm.frame)} instance triangles, "
        f"{warm.frame.dense_leaf_lo.shape[0]} leaves, tree levels {leaves[2].sizes}; "
        f"leaf box extent (largest axis) p50/p90/p99 {ext_q}, max {float(ext.max())}, "
        f"{int((ext > 1.0).sum())} leaves wider than 1")
    c_lo, c_hi, c_tree = T._chunk_tables(warm.frame)
    chunks = (c_lo, c_hi, c_tree, T._slice_table(warm.frame))
    log(f"colonnade-2M: K1b's chunk tree levels {c_tree.sizes}")
    del warm
    reports["packet_trace"] = k6_phase(launches, leaves, chunks=chunks, check_rays=HUGE_CHECK,
                                       lights=2)
    del launches, leaves, chunks
    torch.cuda.empty_cache()
    elapsed()

    run_path("colonnade-2M", colonnade_2m, counts(packet_trace=4))
    psnrs, _agree = reference_phase(sponza_like_scene, SPONZA_REF_FRAMES, traversal_impl="pallas")
    log(f"reference packet route (colonnade-5k): {REF_SIZE}x{REF_SIZE} card vs plain-on-CPU "
        "PSNR dB " + " ".join(f"{p:.2f}" for p in psnrs))
    # the same scene on the two-level BVH walk, beside K6's frames
    run_path("colonnade-2M-walk", colonnade_2m, counts(bvh_walk=3), frames_n=WALK_2M_FRAMES,
             traversal_impl="jax")
    log(f"colonnade-2M 1080p bf16 frame ms: BVH walk {path_ms['colonnade-2M-walk']:.3f}, "
        f"packet BVH (K6) {path_ms['colonnade-2M']:.3f}")
    elapsed()

    # ---- colonnade-8M: above packet_bvh_max_tris, 'auto' takes the BVH walk
    reports["bvh_walk"], reports["bvh_walk_ref"] = walk_kernel_phase()
    elapsed()
    run_path("colonnade-8M", colonnade_8m, counts(bvh_walk=3))
    psnrs, _agree = reference_phase(lambda: sponza_like_scene(3, 1), WALK_REF_FRAMES,
                                    traversal_impl="jax")
    log(f"reference walk route (colonnade-830, traversal_impl='jax'): {REF_SIZE}x{REF_SIZE} "
        "card vs plain-on-CPU PSNR dB " + " ".join(f"{p:.2f}" for p in psnrs))
    # the all-pairs route (plain PyTorch): one Cornell frame
    run_path("flagship-dense", cornell_box_scene, counts(), frames_n=1, traversal_impl="dense")
    elapsed()

    # ---- fp32 (the f32 'both' band): the flagship's K1a
    cfg32 = RenderConfig(width=W, height=H, precision="fp32")
    warm = Renderer(cornell_box_scene(), cfg32)
    calls = capture_inputs(warm, 2)
    del warm
    reports32 = kernel_phase(calls, names=("dense_trace",), tag=" fp32")
    del calls
    torch.cuda.empty_cache()
    elapsed()

    _t, flag32_img, _aux = run_path("flagship-fp32", cornell_box_scene,
                                        counts(dense_trace=2), "fp32")
    from low_precision_raytracer_tpu_torch.utils.image import psnr, ssim

    a, b = flag_img.float().cpu().numpy(), flag32_img.float().cpu().numpy()
    log(f"parity flagship 1080p frame {PATH_FRAMES} (seed 0), bf16 vs fp32: "
        f"PSNR {psnr(a, b):.3f} dB, SSIM {ssim(a, b):.5f}")
    del flag_img, a
    psnrs, _agree = reference_phase(cornell_box_scene, REF_FRAMES, "fp32")
    log(f"reference flagship-fp32: {REF_SIZE}x{REF_SIZE} card vs plain-on-CPU PSNR dB "
        + " ".join(f"{p:.2f}" for p in psnrs))
    elapsed()

    # ---- fp16 (the 'mxu3' test on the kernel routes): the flagship's K1a
    cfg16 = RenderConfig(width=W, height=H, precision="fp16")
    warm = Renderer(cornell_box_scene(), cfg16)
    calls = capture_inputs(warm, 2)
    del warm
    reports16 = kernel_phase(calls, names=("dense_trace",), tag=" fp16")
    del calls
    torch.cuda.empty_cache()
    _t, flag16_img, _aux = run_path("flagship-fp16", cornell_box_scene,
                                        counts(dense_trace=2), "fp16")
    a = flag16_img.float().cpu().numpy()
    log(f"parity flagship 1080p frame {PATH_FRAMES} (seed 0), fp16 vs fp32: "
        f"PSNR {psnr(a, b):.3f} dB, SSIM {ssim(a, b):.5f}")
    del flag16_img, flag32_img, a, b
    psnrs, _agree = reference_phase(cornell_box_scene, REF_FRAMES, "fp16")
    log(f"reference flagship-fp16: {REF_SIZE}x{REF_SIZE} card vs plain-on-CPU PSNR dB "
        + " ".join(f"{p:.2f}" for p in psnrs))
    elapsed()

    # ---- fp32 Sponza-class: K1b; the fp32 packet route on it: K6
    warm = Renderer(sponza_like_scene(), cfg32)
    launches = capture_sponza_launches(warm, 2)
    del warm
    reports32["dense_trace_multi"] = k1b_phase(launches, reps=5, plain_on_slice=True,
                                               scene="sponza-fp32")
    del launches
    torch.cuda.empty_cache()
    run_path("sponza-fp32", sponza_like_scene, counts(dense_trace_multi=4), "fp32")
    elapsed()

    warm = Renderer(sponza_like_scene(), RenderConfig(width=W, height=H, precision="fp32",
                                                      traversal_impl="pallas"))
    launches = capture_packet_launches(warm, 2)
    leaves = T._packet_tables(warm.frame)
    del warm
    reports32["packet_trace"] = k6_phase(launches, leaves, scene="sponza-fp32 packet route")
    del launches, leaves
    torch.cuda.empty_cache()
    run_path("sponza-fp32-packet", sponza_like_scene, counts(packet_trace=4), "fp32",
             frames_n=4, traversal_impl="pallas")
    elapsed()

    # ---- colonnade-328k (bf16): K1b at 2,567 chunks, the wavefront
    k1b_328k, sched_328k = colonnade_328k_kernel_phase(cfg)
    log(f"colonnade-328k K1b: {json.dumps(k1b_328k)}")
    log("colonnade-328k schedule (ms, bound ms from the walk's box tests / the flat scan's): "
        + json.dumps([dict(kind=r["kind"], ms=r["ms"], bound_ms=r["bound_ms"],
                           bound_ms_flat=r["bound_ms_flat"]) for r in sched_328k]))
    run_path("colonnade-328k", colonnade_328k, big)
    elapsed()

    # ---- fp16 colonnade-83k: K1b and the wavefront ('mxu3'), K5 on its lanes
    warm = Renderer(colonnade_83k(), RenderConfig(width=W, height=H, precision="fp16"))
    calls = capture_big_launches(warm, 2)
    del warm
    for kind, (_n, a, kw) in zip(("gi", "shadow1"), calls[2:]):
        k5_holds("colonnade-83k fp16", kind, a, kw, lights=2 if kw["find_any"] else 1)
    del calls
    torch.cuda.empty_cache()
    run_path("colonnade-83k-fp16", colonnade_83k, big, "fp16", frames_n=4)
    elapsed()

    # ---- the widened error bands: K1a, K1b and K6 under each acceptance
    band_reports = {}
    for precision, fallback in BAND_ACCS:
        band_reports[f"{precision}-{fallback}"] = band_kernel_phase(precision, fallback)
        elapsed()
    run_path("sponza-fp16-both", sponza_like_scene, counts(dense_trace_multi=4), "fp16",
             frames_n=4, triangle_fallback="both")
    run_path("flagship-bf16-dtype", cornell_box_scene, counts(dense_trace=2), "bf16",
             frames_n=4, triangle_fallback="dtype")
    run_path("colonnade-5k-packet-fp16-both", sponza_like_scene, counts(packet_trace=4),
             "fp16", frames_n=4, traversal_impl="pallas", triangle_fallback="both")
    fallback_lines()
    elapsed()

    # ---- the bands above the old 8,192-triangle cap: K1b's walk on
    # colonnade-83k, K6's on colonnade-2M, each held against the scan kernel
    for name, precision, fallback in BIG_BAND_ACCS:
        band_big_kernel_phase(name, precision, fallback)
        packet = name == "colonnade-2M"
        run_path(f"{name}-{precision}-{fallback}", colonnade_2m if packet else colonnade_83k,
                 counts(**{"packet_trace" if packet else "dense_trace_multi": 4}), precision,
                 frames_n=BIG_BAND_FRAMES, triangle_fallback=fallback)
        elapsed()

    # ---- the packed epilogue (K1a, K1b), the wavefront's 'rounds' mode
    reports.update(pack_phases(run_path, counts))
    elapsed()
    rounds_reports = rounds_kernel_phase()
    # a 'rounds' cycle runs the schedule once and K5 once a round (and the
    # tail passes one each)
    rounds_counts = counts(
        dense_trace_multi=2,
        wavefront_schedule=lambda got: got["wavefront_schedule"] >= 2,
        wavefront_assigned=lambda got: got["wavefront_assigned"] >= got["wavefront_schedule"])
    run_path("colonnade-83k-rounds", colonnade_83k, rounds_counts, frames_n=4,
             wavefront_mode="rounds")
    psnrs, _agree = reference_phase(colonnade_83k, 2, wavefront_mode="rounds")
    log(f"reference colonnade-83k rounds: {REF_SIZE}x{REF_SIZE} card vs plain-on-CPU PSNR dB "
        + " ".join(f"{p:.2f}" for p in psnrs))
    log("rounds vs oneshot, colonnade-83k 1080p wavefront launches (ms): " + json.dumps(
        [dict(kind=r["kind"], rounds_ms=r["rounds_ms"], oneshot_ms=r["oneshot_ms"],
              **r["stats"]) for r in rounds_reports]))
    elapsed()

    # ---- the Q2.4 tool: the VPU and the tensor-core chunk bodies
    for nchunk in (1, 8):
        tool_reports, tool_launches = tool_phase(nchunk)
        for name, n in tool_launches.items():
            totals[name] += n
        if nchunk == 1:  # the kernels line takes NCHUNK = 1; NCHUNK = 8 is logged
            reports.update(tool_reports)
    elapsed()

    if "--profile" in argv:
        profile_frame("flagship", cornell_box_scene)
        profile_frame("sponza", sponza_like_scene)
        profile_frame("colonnade-83k", colonnade_83k)
        profile_frame("colonnade-2M", colonnade_2m)
        profile_frame("flagship-fp32", cornell_box_scene, "fp32")
        profile_frame("flagship-fp16", cornell_box_scene, "fp16")
        profile_frame("colonnade-328k", colonnade_328k)

    def kernel_line(names, reps, launches, extra=()):
        return [dict(name=name, route="cuda", source=KERNELS[name][0],
                     replaces=KERNELS[name][1], launches=launches[name],
                     max_abs_err=reps[name]["max_abs_err"], ms=reps[name]["ms"],
                     plain_ms=reps[name]["plain_ms"], bound_ms=reps[name]["bound_ms"],
                     bound_by=reps[name]["bound_by"], library_ms=None,
                     **{k: reps[name].get(k) for k in extra}) for name in names]

    for name in KERNELS:
        if name in OFF_PATH:
            if totals[name]:
                raise AssertionError(f"{name}: launched on a path phase")
            continue
        if totals[name] == 0:
            raise AssertionError(f"{name}: no launch on any path phase")
    log(json.dumps({"kernels_fp32": kernel_line(reports32, reports32, group_totals["fp32"])}))
    log(json.dumps({"kernels_fp16": kernel_line(reports16, reports16, group_totals["fp16"])}))
    # launches under each acceptance: null where no path phase ran it
    none = dict.fromkeys(cuda_lib.LAUNCHES)
    # the walks' ms beside the all-row scan kernel's on the same launches
    log(json.dumps({"kernels_band": {acc: kernel_line(r, r, group_totals.get(acc, none),
                                                      extra=("scan_ms",))
                                     for acc, r in band_reports.items()}}))
    # K3's and K4's new forms: the float exponent and the strides above 16
    sig = option_reports[f"sigma_n={SIGMA_N_FLOAT}"]
    wide = option_reports["strides to 64"]["wavelet_iter"]["per"]
    reports["temporal_accum"]["ms_sigma_n_float"] = sig["temporal_accum"]["ms"]
    reports["wavelet_iter"]["ms_sigma_n_float"] = sig["wavelet_iter"]["ms"]
    reports["wavelet_iter"]["ms_by_stride_wide"] = {p["stride"]: p["ms"] for p in wide}
    for name in ("temporal_accum", "wavelet_iter"):
        reports[name]["max_abs_err"] = max(
            [reports[name]["max_abs_err"]]
            + [r[name]["max_abs_err"] for r in option_reports.values()])
    log(json.dumps({"kernels": kernel_line(KERNELS, reports, totals, extra=(
        "ms_sigma_n_float", "ms_by_stride_wide"))}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
