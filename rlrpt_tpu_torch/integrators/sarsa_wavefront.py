"""Regenerative-wavefront expected-SARSA tracer, the fast RL path
(counterpart of ``rlrpt_tpu/integrators/sarsa_wavefront.py``).

The learning rule and estimator of integrators.reinforcement_tracer (ref:
reinforcement_path_tracing.cu:50-120, radiance_map.cu:91-146) on a
wavefront of ray slots:

* a slot owns pix_mux pixels (ids slot + k*w0) and starts the next sample,
  then the next pixel, the moment a sample ends, so each iteration's work
  is spent on live rays;
* cascaded drain: once the live count fits a drain_factor-times narrower
  wavefront, the live slots are compacted to a prefix, the dead tail's
  banked radiance is flushed to the image, and a narrower copy of the loop
  goes on (dead slots never revive, so the prefix holds all the remaining
  work);
* between phase boundaries nothing is compacted: the closest-hit kernel
  traces up to the last live slot, a high-water mark ``m`` that stays a
  device int32 tensor;
* the hit is kernel B4a (``closest_hit_mat_mxu``), whose material row
  carries the class table's triangle class in column 11, or kernel B4b
  (``closest_hit_packed``) with per-field gathers under hit_mode "f32";
* the nearest volume comes from the answer table (VolumeClassTable) or the
  bucket grid (VolumeGrid); the mat row's normal is exact f32, so the
  grid's exact-normal filter reads it directly;
* the TD bootstrap irradiance is column S of the carried CDF rows
  (``cdfplus``), refreshed from the updated Q grid every iteration;
* on the card, with the answer table, B4a's class ids and no mesh, a
  step's nearest volume and TD update are four launches of
  ``ops.sarsa_td`` (``csrc/sarsa_td.cu``): the table's lookup; the
  targets; the scatter into a scratch kept zero between steps; the apply,
  in place on the frame's own copy of Q and visits, of the entries that
  received targets, with the irradiance of their rows.  Elsewhere (the
  CPU, the bucket grid, hit_mode "f32", a mesh, whose ranks sum the
  scatter before the apply) the TD update is the former torch code over
  the whole table, and the lookup the kernel only where B4a's class ids
  lie on the card (it is exact).  The names ``find_closest_volume_table``
  and ``sarsa_contributions`` are the wrappers of ``ops.sarsa_td``,
  called through this module, so a caller that patches them reaches both
  routes;
* a step's sector draw and transport are one launch of
  ``ops.sarsa_transport.sample_transport`` (``csrc/sarsa_transport.cu``),
  which reads each lane's CDF row in place in ``cdfplus`` (the step never
  writes its columns ``:S``); under sampler "hier" the frame draws the
  sector with the two-level tables and the same kernel transports
  (``ops.sarsa_transport.transport``).  On the CPU both run their plain
  twins, the frame's former torch code of the two stages;
* on that kernel route (the card, the answer table, B4a, no mesh) the
  frame replays each step from a CUDA graph of its width (``_graph_route``;
  the CPU, a mesh, the bucket grid and hit_mode "f32" run every step op by
  op).  A ``_GraphSet``, kept across frames of one key (the frame's
  shapes, configuration and answer table; ``_GRAPH_SETS`` holds the newest
  key's alone), holds static copies of the frame's tables (the packed
  scene and its tree, the carried CDF rows, the two-level tables, the
  volumes' frames, Q, visits and the scratch), its lanes' ids, statistics
  and counts, a generator registered with every graph (the frame's own
  draws, in its order: a frame seeded as an eager one draws the same
  uniforms, and the caller's generator ends where the eager frame leaves
  it), per phase width a static slot state, and its graphs.  A width's
  first step runs op by op, the very body its graph holds: the step's
  iteration and ray counts, the step, its output copied back into the
  static state.  Then that body is captured (``_capture``: no wait for the
  card, no release of the allocator's cache, one memory pool for the
  set's step graphs) and every later step of that width replays it,
  ``SYNC_EVERY`` replays to a live-count read.  The graphs are held for
  the camera, whose position and basis the transport's launch parameters
  carry, and for what each name of ``_STEP_NAMES`` is bound to: a frame
  with a moved camera, or a caller that patches a name, captures each
  width anew in the same set, into the memory of the graph it replaces.
  An armed step replays the same graph between two graphs of copies into
  one of ``SYNC_EVERY`` record slots (its input state and tables before,
  its own tensors and tables after), which the host copies for an
  explicit step at once and for ``tail_records`` at the final phase's
  end.  The frame copies its tables in at its start and its Q and visits
  out at its end, so what it returns never aliases a static buffer.

A batch of TD updates is one wavefront iteration (mixed bounce depths and
samples), where the lockstep tracer's is one bounce of one sample; the
reference's atomics serialise its updates in any order, so both are valid
serialisations.  The per-iteration scatter goes through one pair of
(V*S+1,) buffers allocated for the frame.

The loop reads the live count on the host once every ``SYNC_EVERY``
iterations (the JAX package decides inside a while_loop).  The live count
never rises, so a late read only delays a phase exit; an iteration with no
live slot changes nothing and is not counted.  Randomness comes from one
``torch.Generator`` (JAX: threefry), so images match the JAX package's in
distribution, not per pixel.  A step draws its uniforms in a fixed order:
the sampler's, Russian roulette's, the regenerated camera rays' jitter.

Tracing (``utils.profiling``), only while a profiler records: spans
``trace_frame_sarsa_wavefront.<phase>`` (pack: the packed tables, the
tree, the carried CDF rows and the scratch; slots: the slot state, the
image and the statistics; step: one step of the loop, its iteration count
and tallies around the stages hit, volume, td: its closest hit, nearest
volume, and TD targets, scatter, apply and irradiance refresh; sample: its
uniforms (and the two-level sampler's draw); transport: the kernel's
launch, or its twins on the CPU; compact and flush: a drain; capture: an
armed step's copies for ``CAPTURE``; totals: the phases' iteration counts
and the counters) and ``render_frame_sarsa_wavefront.rebuild`` and
``.assemble`` (the image's division and the aux), and on the graph route
``trace_frame_sarsa_wavefront.replay`` (a replay, inside ``.step``, whose
stage spans then never open) and ``.graph_capture`` (a width's captures);
the host waits ``sync.live_count`` (the live-count reduction and read),
``sync.flush`` (the flush's two masked indexes), ``sync.camera`` (the
origin's copy to the card) and ``sync.class_ids`` (the class table's range
check in ``pack_scene_mxu``); the counts ``sarsa_wavefront.frames``,
``.steps``, ``.transport_launches`` (host: the launches of the
sample-and-transport kernel, one a replay, none a capture),
``.td_kernel_steps`` (host: the steps whose lookup and TD update ran on
the kernels), ``.graph_steps`` (host: the steps replays ran) and
``.iterations``, ``.rays`` (device: live iterations, live rays traced,
replayed steps' too).  Every op of a frame lies inside one of these spans
or a helper's.  A ``Capture`` in the module attribute ``CAPTURE`` keeps
chosen steps' tensors for a comparison from outside; without one the frame
checks the attribute once a step.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from rlrpt_tpu_torch.camera import Camera
from rlrpt_tpu_torch.config import RadianceVolumeConfig, RenderConfig
from rlrpt_tpu_torch.integrators.wavefront import (_primary_dirs,
                                                   primary_dirs_u)
from rlrpt_tpu_torch.ops.hemisphere import sector_cos_thetas
from rlrpt_tpu_torch.ops.bvh import Bvh, build_bvh
from rlrpt_tpu_torch.ops.intersect_pallas import (closest_hit_mat_mxu,
                                                  closest_hit_packed,
                                                  pack_scene_mxu,
                                                  pack_triangles)
from rlrpt_tpu_torch.ops.linalg import make_frame
from rlrpt_tpu_torch.ops.sarsa_td import (apply_refresh,
                                          find_closest_volume_table,
                                          sarsa_contributions, targets_plain,
                                          td_frame, td_targets)
from rlrpt_tpu_torch.ops.sarsa_transport import KERNEL as TRANSPORT
from rlrpt_tpu_torch.ops.sarsa_transport import (Frame, Hit,
                                                 sample_transport,
                                                 transport)
from rlrpt_tpu_torch.parallel.mesh import any_rank, psum
from rlrpt_tpu_torch.radiance.grid_bucket import (VolumeClassTable,
                                                  find_closest_volume_grid)
from rlrpt_tpu_torch.radiance.volumes import (RadianceVolumes, _uniforms,
                                              apply_sarsa_contributions,
                                              hier_cdf_tables,
                                              irradiance_estimates,
                                              rebuild_cdf,
                                              sample_from_cdf_hier_u,
                                              td_scratch)
from rlrpt_tpu_torch.scene.scene import Scene
from rlrpt_tpu_torch.utils import profiling

INF_CUT = 1.0e38
SYNC_EVERY = 2

#: Width divisor between drain phases and the narrowest phase run.
DRAIN_FACTOR = 4
MIN_DRAIN_W = 512

#: A ``Capture`` armed by a caller that checks chosen steps from outside
#: the frame (the benchmark's comparison), or None.
CAPTURE = None

#: The graph route's static set (``_GraphSet``) under its key: the newest
#: frame's alone.  It holds copies of a frame's tables, not the caller's
#: (whose carried volumes are new tensors each frame), so no object of the
#: caller lives as long as it, as a network's Adam state does for
#: ``deep.neural_q``'s graphs; a frame of another key replaces it.
_GRAPH_SETS: dict = {}
#: The stream each card's graphs are captured on.
_STREAMS: dict = {}

#: The module-level names a step calls.  The set's graphs are held for
#: what each is bound to, so a caller that patches one (the benchmark's
#: planted faults) captures anew and replays the patch.
_STEP_NAMES = ("closest_hit_mat_mxu", "find_closest_volume_table",
               "td_targets", "sarsa_contributions", "apply_refresh",
               "_uniforms", "make_frame", "sample_from_cdf_hier_u",
               "sample_transport", "transport", "Hit")


class _State(NamedTuple):
    # per slot, sliced at each drain step
    o: torch.Tensor           # (W, 3)
    d: torch.Tensor           # (W, 3)
    tp: torch.Tensor          # (W, 3)
    pixel: torch.Tensor       # (W,) int64 current pixel id
    kmx: torch.Tensor         # (W,) int64 pixel-multiplex index
    bounce: torch.Tensor      # (W,) int32
    remaining: torch.Tensor   # (W,) int32 samples left after the current
    active: torch.Tensor      # (W,) bool
    sample_rad: torch.Tensor  # (W, 3) radiance of the current sample
    slot_rad: torch.Tensor    # (W, pix_mux, 3) finished samples of the
                              # slot's k-th pixel, flushed to the image at
                              # drain boundaries
    cur_vol: torch.Tensor     # (W,) int64 volume awaiting a TD target
    cur_sector: torch.Tensor  # (W,) int64, -1 = no pending update
    cur_brdf: torch.Tensor    # (W,) f32 previous surface luminance / pi


_SLOT_FIELDS = _State._fields


class Capture:
    """What a frame keeps of itself while armed (``CAPTURE``).

    ``iterations``: the frame's steps (counted from 0 over every phase) to
    record; ``tail``: also record the final phase's steps, keeping the last
    SYNC_EVERY (the last step with a live slot is among them).  A record
    is a dict of the step's tensors: its input state ``state`` (a
    ``_State``), the hit (``t``, ``tri``, ``mrow``; ``mrow`` None under
    hit_mode "f32"), the nearest volumes ``next_vol``, the tables before
    the update (``q``, ``visits``, and ``cdfplus``, the carried CDF rows
    with the irradiance column), the TD ``target`` and the ``pending``
    mask, the tables after it (``q_after``, ``visits_after``, and ``irr``,
    the refreshed irradiance column), the sampler's uniforms ``r`` and
    ``u`` (the row sampler's; None under "hier"), its ``sector`` and
    ``pdf``, the regenerated rays' jitter ``u_pix``, and the output state
    ``out``; plus ``step``, ``phase``, ``width`` and ``live``.  The
    step's tensors are new each step and never written again, so a record
    holds them; the Q and visit tables and the carried rows, which the
    kernels update in place, are copied, in armed steps only.  On the
    graph route an armed step replays the width's graph, as every step
    does, between two graphs of copies into a record slot, which the host
    copies (``_kept``) into its record: field for field the same.
    ``flushes``: every flush's (pixel, kmx, slot_rad) copies, in order;
    ``w0``, the slots;
    ``steps``, the frame's steps; ``q_final``, ``visits_final`` and
    ``cdf``, the frame's Q and visits before the CDF rebuild in
    ``render_frame_sarsa_wavefront`` and the CDF after it."""

    def __init__(self, iterations=(), tail: bool = False):
        self.iterations = frozenset(iterations)
        self.tail = tail
        self.records: dict = {}
        self.tail_records: list = []
        self.flushes: list = []
        self.w0 = None
        self.steps = 0
        self.q_final = self.visits_final = self.cdf = None

    def want(self, step: int, last_phase: bool):
        """The record to fill for this step, or None."""
        if step in self.iterations:
            rec = self.records[step] = {}
        elif self.tail and last_phase:
            rec = {}
        else:
            return None
        if self.tail and last_phase:
            self.tail_records = (self.tail_records + [rec])[-SYNC_EVERY:]
        return rec

    def flush(self, pixel, kmx, slot_rad) -> None:
        self.flushes.append((pixel.clone(), kmx.clone(), slot_rad.clone()))


def _kept(rec: dict) -> dict:
    """A copy of a record slot that later steps leave alone."""
    out = {}
    for name, v in rec.items():
        if isinstance(v, _State):
            v = _State(*(a.clone() for a in v))
        elif isinstance(v, torch.Tensor):
            v = v.clone()
        out[name] = v
    return out


def _kernel_route(device: torch.device, grid, hit_mode: str, mesh) -> bool:
    """Whether a frame takes the kernels of ``ops.sarsa_td``: on the card,
    with the answer table and B4a's class ids, without a mesh (whose ranks
    sum the scatter before the apply, so it keeps the whole-table torch
    code)."""
    return (device.type == "cuda" and isinstance(grid, VolumeClassTable)
            and hit_mode == "mxu" and mesh is None)


def _graph_route(device: torch.device, grid, hit_mode: str, mesh) -> bool:
    """Whether a frame replays its steps as CUDA graphs: wherever it takes
    the kernel route.  The tests' switch: patched to False, a frame on the
    kernel route runs every step op by op, the graphs' reference."""
    return _kernel_route(device, grid, hit_mode, mesh)


class _Graph:
    """A width's step as a CUDA graph: ``replay``; ``slot``, the step's
    record fields (tensors of the graph's pool, which each replay
    rewrites); ``held``, the set's ``held`` it was captured for;
    ``copies``, for each of ``SYNC_EVERY`` record slots the graphs of an
    armed step's copies before and after its replay and the slot they fill
    (made at its capture in an armed frame, else at its first armed
    replay)."""

    def __init__(self, replay, slot: dict, held: tuple):
        self.replay, self.slot, self.held, self.copies = (replay, slot, held,
                                                          [])


class _GraphSet:
    """The graph route's static buffers for frames of one key, kept across
    frames: ``t``, copies of a frame's tables by name (``load``); ``bvh``
    over the static triangles; ``td``, the ``TdFrame`` over the static Q,
    visits, carried rows, cosines and luminances; ``lane``, the lanes'
    ids; ``stats``; ``rays``, a frame's live rays (an int64 device
    scalar); ``gen``, the generator every graph registers; per width a
    static slot state (``states``) and the phase's live iterations
    (``iters``, int64 device scalars); ``graphs``, each width's
    ``_Graph``, replayed while captured for ``held``: the frame's camera,
    whose position and basis the transport's launch parameters carry, and
    what each name of ``_STEP_NAMES`` is bound to; ``pool``, the step
    graphs' memory pool."""

    def __init__(self, t: dict, vols: RadianceVolumes, depth: int, w0: int,
                 threshold: float, env: float):
        device = vols.device
        own = ("q", "visits", "surface_lum")   # the TdFrame's
        self.t = {k: torch.empty_like(a, memory_format=torch.contiguous_format)
                  for k, a in t.items() if k not in own}
        t = self.t
        self.bvh = Bvh(nodes=t["nodes"], order=t["order"],
                       tris_sorted=t["tris_sorted"], depth=depth,
                       source=t["tris"])
        # td_frame checks the tables and copies Q and visits
        td = td_frame(vols, t["cdfplus"], t["cos"], threshold, env)
        self.td = dataclasses.replace(td,
                                      surface_lum=td.surface_lum.clone())
        t.update(zip(own, (self.td.q, self.td.visits, self.td.surface_lum)))
        i64 = dict(dtype=torch.int64, device=device)
        self.lane = torch.arange(1, w0 + 1, dtype=torch.int32, device=device)
        self.stats = {"path_sum": torch.zeros((), dtype=torch.float64,
                                              device=device),
                      "zclp": torch.zeros((), **i64)}
        self.rays = torch.zeros((), **i64)
        self.gen = torch.Generator(device=device)
        self.states: dict = {}
        self.iters: dict = {}
        self.graphs: dict = {}
        self.held = None
        self.pool = None

    def load(self, t: dict, gen: torch.Generator, held: tuple) -> None:
        """Copy a frame's tables and its generator's state in, clear the
        TD scratch and count, the statistics and the ray count, and take
        the frame's ``held``."""
        for k, a in t.items():
            self.t[k].copy_(a)
        sc = self.td.scratch
        for a in (sc.sum_t, sc.cnt, sc.dirty, self.td.count, self.rays,
                  *self.stats.values()):
            a.zero_()
        self.gen.set_state(gen.get_state())
        if held != self.held:
            self.held = held

    def graph(self, wp: int) -> _Graph | None:
        """The width's graph if captured for the frame's ``held``, else
        None: the frame captures it anew, and the old one goes only then,
        so the pool is never left without a graph (torch allows no capture
        into a pool whose every graph has gone)."""
        g = self.graphs.get(wp)
        return g if g is not None and g.held is self.held else None

    def enter(self, st: _State, wp: int) -> _State:
        """The width's static slot state with ``st`` copied in, the phase's
        iteration count cleared."""
        static = self.states.get(wp)
        if static is None:
            static = self.states[wp] = _State(*(torch.empty_like(
                a, memory_format=torch.contiguous_format) for a in st))
            self.iters[wp] = torch.zeros((), dtype=torch.int64,
                                         device=st.active.device)
        for a, b in zip(static, st):
            a.copy_(b)
        self.iters[wp].zero_()
        return static


def _capture(body, gen: torch.Generator | None = None,
             gs: _GraphSet | None = None):
    """``body()`` captured as a CUDA graph on the card's capture stream,
    its draws from ``gen`` advancing it as the calls would, in the memory
    pool of the set ``gs`` or in a pool of its own; returns the graph's
    replay.  Unlike ``torch.cuda.graph`` it neither waits for the card nor
    empties the allocator's cache, which a frame with a moved camera would
    pay for each width.  The set's step graphs share its pool, so a moved
    camera's captures reuse the memory of the graphs they replace: one
    runs at a time, and its outputs (``_Graph.slot``) are read only by the
    copy graphs right after its replay, before another step graph runs, as
    sharing a pool asks.  The copy graphs' record slots outlive the next
    step's replay, so they keep pools of their own."""
    device = torch.device("cuda", torch.cuda.current_device())
    stream = _STREAMS.get(device)
    if stream is None:
        stream = _STREAMS[device] = torch.cuda.Stream(device)
    pool = ()
    if gs is not None:
        if gs.pool is None:
            gs.pool = torch.cuda.graph_pool_handle()
        pool = (gs.pool,)
    graph = torch.cuda.CUDAGraph()
    if gen is not None:
        graph.register_generator_state(gen)
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin(*pool)
        try:
            body()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    return graph.replay


def _graph_set(key: tuple, make) -> _GraphSet:
    """The set kept under ``key``, else ``make()``'s, replacing any other."""
    gs = _GRAPH_SETS.get(key)
    if gs is None:
        _GRAPH_SETS.clear()
        gs = _GRAPH_SETS[key] = make()
    return gs


def _live_above(active: torch.Tensor, width: int, mesh) -> bool:
    """Whether more than ``width`` slots are live (on any rank): the
    loop's one read of the card, its reduction inside the wait's span."""
    with profiling.host_sync("live_count", active):
        return any_rank(active.sum() > width, mesh)


def _compact(s, wp: int):
    """Permute the fields of a slot state (a NamedTuple of per-slot
    tensors with an ``active`` field) so live slots form a prefix, each
    part in its old order."""
    act = s.active
    m = act.sum()
    arange = torch.arange(wp, device=act.device)
    slot_pos = torch.where(act, torch.cumsum(act, 0) - 1,
                           m + torch.cumsum(~act, 0) - 1)
    perm_src = torch.empty_like(arange).scatter_(0, slot_pos, arange)
    return type(s)(*(a[perm_src] for a in s))


def _flush(image: torch.Tensor, pixel: torch.Tensor, kmx: torch.Tensor,
           slot_rad: torch.Tensor, w0: int, pix_lo: int = 0) -> torch.Tensor:
    """Add the slots' banked radiance rows to ``image`` (n_pix_local, 3),
    the pixels from ``pix_lo`` on, in place.  Slot s0's k-th pixel is
    pix_lo + s0 + k*w0, and s0 = pixel - pix_lo - kmx*w0 from the slot's
    current pixel; ids past the image are dropped.  Each pixel belongs to
    one slot, so the adds never collide."""
    n_pix, pix_mux = image.shape[0], slot_rad.shape[1]
    s0 = pixel - pix_lo - kmx * w0
    idx = s0[:, None] + torch.arange(pix_mux, device=pixel.device) * w0
    valid = (idx >= 0) & (idx < n_pix)
    image.index_add_(0, idx[valid], slot_rad[valid])
    return image


def _phase_widths(w0: int, drain_factor: int, min_drain_w: int) -> list:
    widths = [w0]
    while widths[-1] // drain_factor >= min_drain_w:
        widths.append(widths[-1] // drain_factor)
    return widths


def trace_frame_sarsa_wavefront(generator_or_seed, scene: Scene,
                                camera: Camera, vols: RadianceVolumes, grid,
                                cfg: RenderConfig, rl: RadianceVolumeConfig,
                                pix_mux: int = 1, mesh=None, pix_lo: int = 0,
                                n_pix_local: int | None = None,
                                hit_mode: str = "mxu", sampler: str = "row",
                                frame_mode: str = "hit",
                                drain_factor: int = DRAIN_FACTOR,
                                min_drain_w: int = MIN_DRAIN_W,
                                cdf_dtype: str = "f32"):
    """One frame of regenerative SARSA tracing, no CDF rebuild.  Returns
    (image_sum (n_pix_local, 3), the SUM over spp of the pixels from
    ``pix_lo`` on; vols; path_sum; zclp; iters, the iterations with a
    live slot; td_count; phase_iterations (a device tensor); phase_widths
    (ints)), the statistics device tensors.

    ``pix_lo`` and ``n_pix_local`` carve out this shard's pixel range
    [pix_lo, pix_lo + n_pix_local) (the whole frame by default).  With a
    ``mesh`` (parallel.mesh) every rank holds its shard and a replica of
    the volumes: each iteration's TD contributions and scatter count are
    summed over the ranks before the update, and a phase ends only when
    every rank's live count fits the next width, so all ranks compact and
    narrow together and run the same number of iterations (a rank whose
    slots are all dead steps on, changing nothing).  path_sum, zclp and
    iters stay the rank's own.

    ``generator_or_seed``: a torch.Generator on the volumes' device, or an
    int seed for one.  ``grid``: a VolumeClassTable or a VolumeGrid.
    hit_mode "mxu": kernel B4a with the material row (class ids in column
    11 for a class table); "f32": kernel B4b and gathers.  sampler "row"
    draws from the gathered CDF row, "hier" from two-level tables (the
    same distribution).  frame_mode "hit" samples in the frame of the hit
    normal, "volume" in the matched volume's.  cdf_dtype "bf16" stores the
    carried rows in bfloat16: the pdf is taken from the same rounded rows,
    so the image stays unbiased.
    """
    for name, val, ok in (("hit_mode", hit_mode, ("mxu", "f32")),
                          ("sampler", sampler, ("row", "hier")),
                          ("frame_mode", frame_mode, ("hit", "volume")),
                          ("cdf_dtype", cdf_dtype, ("f32", "bf16"))):
        if val not in ok:
            raise ValueError(f"{name} must be one of {ok}, got {val!r}")
    device = vols.device
    gen = generator_or_seed
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=device).manual_seed(int(gen))
    span = profiling.span
    counting = profiling.recording()
    rec_ = profiling.RECORDER
    cap = CAPTURE
    is_table = isinstance(grid, VolumeClassTable)
    td_kernels = _kernel_route(device, grid, hit_mode, mesh)
    graphed = _graph_route(device, grid, hit_mode, mesh)
    v, s = vols.n_volumes, vols.n_sectors
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    n_pix = cfg.n_pixels
    n_local = n_pix if n_pix_local is None else n_pix_local
    pix_end = pix_lo + n_local
    spp = cfg.samples_per_pixel
    w0 = -(-n_local // pix_mux)        # slots; slot i owns i + k*w0, k<mux
    frames = vols.frame if frame_mode == "volume" else None
    caller_gen = gen
    gs = None
    with span("trace_frame_sarsa_wavefront.pack"):
        scene = scene.to(device)
        if hit_mode == "mxu" and is_table:
            # pack_scene_mxu checks the class ids' range on the host
            with profiling.host_sync("class_ids", grid.tri_class):
                tris, mat = pack_scene_mxu(scene, tri_class=grid.tri_class)
        elif hit_mode == "mxu":
            tris, mat = pack_scene_mxu(scene)
        else:
            tris = pack_triangles(scene)
        bvh = build_bvh(tris)   # once a frame, on the table's device
        if sampler == "hier":
            cdf_c, cdf_f = hier_cdf_tables(vols.cdf, rl.grid_resolution)
        sec_cos = sector_cos_thetas(vols.grid_resolution, device)
        cdfplus = torch.cat([vols.cdf, irradiance_estimates(vols)[:, None]],
                            dim=1).to(torch.bfloat16 if cdf_dtype == "bf16"
                                      else torch.float32)
        if graphed:
            # the frame's tables copied into the static set of its key,
            # which every step then reads and writes, graphed or not
            t = {"tris": tris, "mat": mat, "nodes": bvh.nodes,
                 "order": bvh.order, "tris_sorted": bvh.tris_sorted,
                 "cdfplus": cdfplus, "cos": sec_cos, "q": vols.q,
                 "visits": vols.visits, "surface_lum": vols.surface_lum}
            if sampler == "hier":
                t.update(cdf_c=cdf_c, cdf_f=cdf_f)
            if frames is not None:
                t["frames"] = frames
            set_key = (device, tuple((name, a.shape, a.dtype)
                                     for name, a in t.items()),
                       bvh.depth, cfg, rl, pix_mux, pix_lo, n_local,
                       sampler, frame_mode, drain_factor, min_drain_w,
                       scene.n_surfaces, grid.table.shape, grid.dims,
                       grid.n_slots, tuple(a.data_ptr() for a in (
                           grid.table, grid.tri_class, grid.origin,
                           grid.inv_cell)))
            gs = _graph_set(set_key, lambda: _GraphSet(
                t, vols, bvh.depth, w0, rl.radiance_threshold,
                cfg.environment_light))
            gs.load(t, gen, (camera, tuple(globals()[name]
                                           for name in _STEP_NAMES)))
            gen, td, bvh = gs.gen, gs.td, gs.bvh
            tris, mat, cdfplus = gs.t["tris"], gs.t["mat"], gs.t["cdfplus"]
            if sampler == "hier":
                cdf_c, cdf_f = gs.t["cdf_c"], gs.t["cdf_f"]
            if frames is not None:
                frames = gs.t["frames"]
            vols = dataclasses.replace(vols, q=td.q, visits=td.visits)
        elif td_kernels:
            # the frame's own Q and visits, which the kernels update in
            # place, and a scratch kept zero between steps
            td = td_frame(vols, cdfplus, sec_cos, rl.radiance_threshold,
                          cfg.environment_light)
            vols = dataclasses.replace(vols, q=td.q, visits=td.visits)
        else:
            td = None
            scratch = td_scratch(v, s, device)
        with profiling.host_sync("camera", tris):
            cam_o = torch.tensor(camera.position, **f32)
    ns = scene.n_surfaces
    fr = Frame(w0=w0, n_pix=n_pix, pix_end=pix_end, pix_mux=pix_mux,
               spp=spp, camera=camera, cfg=cfg, gr=rl.grid_resolution,
               grid_rho=rl.grid_rho)
    launches = TRANSPORT.launches

    with span("trace_frame_sarsa_wavefront.slots"):
        lane = torch.arange(1, w0 + 1, **i32) if gs is None else gs.lane
        pix0 = pix_lo + torch.arange(w0, **i64)
        in_image = (pix0 < n_pix) & (pix0 < pix_end)
        st = _State(
            o=cam_o.expand(w0, 3).clone(),
            d=_primary_dirs(gen, pix0, camera, cfg),
            tp=torch.ones((w0, 3), **f32), pixel=pix0,
            kmx=torch.zeros((w0,), **i64), bounce=torch.zeros((w0,), **i32),
            remaining=torch.where(in_image, spp - 1, 0).to(torch.int32),
            active=in_image, sample_rad=torch.zeros((w0, 3), **f32),
            slot_rad=torch.zeros((w0, pix_mux, 3), **f32),
            cur_vol=torch.zeros((w0,), **i64),
            cur_sector=torch.full((w0,), -1, **i64),
            cur_brdf=torch.zeros((w0,), **f32))
        image = torch.zeros((n_local, 3), **f32)
        stats = {"path_sum": torch.zeros((), dtype=torch.float64,
                                         device=device),
                 "zclp": torch.zeros((), **i64)} if gs is None else gs.stats
        td_count = torch.zeros((), **i64)
        no_iters = torch.zeros((), **i64)   # a phase's count starts here
        if gs is not None:
            st = gs.enter(st, w0)

    def step(c: _State, wp: int, rec: dict | None) -> _State:
        nonlocal vols, td_count
        act = c.active
        with span("trace_frame_sarsa_wavefront.hit"):
            # last live lane + 1 (0 when none is live), on the device
            m = torch.max(torch.where(act, lane[:wp], 0)).reshape(1)
            if hit_mode == "mxu":
                t, tri, mrow = closest_hit_mat_mxu(c.o, c.d, tris, mat, m,
                                                   bvh)
                normal, diffuse3 = mrow[:, 0:3], mrow[:, 3:6]
                emission3, lum = mrow[:, 6:9], mrow[:, 10]
                cls = mrow[:, 11].round().to(torch.int32) if is_table \
                    else None
                tri = tri.long()
            else:
                t, tri = closest_hit_packed(c.o, c.d, tris, m, bvh)
                tri = tri.long()
                mrow = None
                normal, diffuse3 = scene.normal[tri], scene.diffuse_c[tri]
                emission3, lum = scene.emission[tri], scene.luminance[tri]
                cls = None
            missed = act & (t >= INF_CUT)
            hit_light = act & ~missed & (tri >= ns)
            hit_surface = act & ~missed & (tri < ns)
            hit_pos = c.o + t[:, None] * c.d

        with span("trace_frame_sarsa_wavefront.volume"):
            # nearest volume at the new vertex
            if is_table:
                next_vol = find_closest_volume_table(grid, hit_pos, tri,
                                                     cls=cls)
            else:
                next_vol = find_closest_volume_grid(grid, hit_pos, normal)
        if rec is not None:
            # the step's own tensors (``before`` and ``after`` copy the
            # tables, which the kernels update in place)
            with span("trace_frame_sarsa_wavefront.capture"):
                rec.update(t=t, tri=tri, mrow=mrow, next_vol=next_vol)

        with span("trace_frame_sarsa_wavefront.td"):
            # TD update of the previously chosen sector, its bootstrap the
            # irradiance column of the new volume's row
            if td is not None:
                target, pending = td_targets(td, c, missed, hit_light, lum,
                                             next_vol)
                sarsa_contributions(c.cur_vol, c.cur_sector, target, pending,
                                    v, s, td.scratch)
                apply_refresh(td)
            else:
                target, pending = targets_plain(c, missed, hit_light, lum,
                                                next_vol, cdfplus,
                                                cfg.environment_light)
                td_add = pending.sum()
                sum_t, cnt = sarsa_contributions(c.cur_vol, c.cur_sector,
                                                 target, pending, v, s,
                                                 scratch)
                if mesh is not None:
                    td_add = psum(td_add.reshape(1), mesh)[0]
                    sum_t, cnt = psum(torch.stack([sum_t, cnt]), mesh)
                td_count = td_count + td_add
                vols = apply_sarsa_contributions(vols, sum_t, cnt,
                                                 rl.radiance_threshold)
                cdfplus[:, -1] = irradiance_estimates(vols, sec_cos).to(
                    cdfplus.dtype)
        if rec is not None:
            with span("trace_frame_sarsa_wavefront.capture"):
                rec.update(target=target, pending=pending)

        with span("trace_frame_sarsa_wavefront.sample"):
            # the step's uniforms: the sampler's, Russian roulette's, the
            # regenerated camera rays' jitter
            if sampler == "hier":
                r = u = None
                u1, u2, uj = _uniforms(gen, wp, (1,), (1,), (2,))
                basis = make_frame(normal) if frames is None else \
                    frames[next_vol]
                new_d, sector, pdf = sample_from_cdf_hier_u(
                    u1, u2, uj, cdf_c, cdf_f, basis, next_vol, rl.grid_rho,
                    rl.grid_resolution)
            else:
                r, u = _uniforms(gen, wp, (1,), (2,))
            u_rr = (torch.rand((wp,), generator=gen, device=device)
                    if cfg.russian_roulette else None)
            u_pix = torch.rand((wp, 2), generator=gen, device=device)

        with span("trace_frame_sarsa_wavefront.transport"):
            hit = Hit(missed, hit_light, hit_surface, hit_pos, normal,
                      diffuse3, emission3, lum, next_vol)
            if sampler == "hier":
                out = transport(c, hit, sector, pdf, new_d, u_rr, u_pix,
                                stats, fr)
            else:
                out, sector, pdf = sample_transport(c, hit, cdfplus, frames,
                                                    r, u, u_rr, u_pix, stats,
                                                    fr)
        if rec is not None:
            with span("trace_frame_sarsa_wavefront.capture"):
                rec.update(r=r, u=u, sector=sector, pdf=pdf, u_pix=u_pix,
                           out=out)
        return out

    def before(rec: dict, c: _State) -> None:
        """An armed step's copies, before it, of what it updates in place:
        the tables, and on the graph route the static slot state."""
        with span("trace_frame_sarsa_wavefront.capture"):
            if gs is not None:
                c = _State(*(a.clone() for a in c))
            rec.update(state=c, q=vols.q.clone(), visits=vols.visits.clone(),
                       cdfplus=cdfplus.clone())

    def after(rec: dict) -> None:
        """An armed step's copies of the tables after it."""
        with span("trace_frame_sarsa_wavefront.capture"):
            rec.update(q_after=vols.q.clone(),
                       visits_after=vols.visits.clone(),
                       irr=cdfplus[:, -1].clone(),
                       live=rec["state"].active.any())

    def body(c: _State, wp: int, rec: dict | None) -> None:
        """One step from the width's static slot state ``c``, its live
        iteration and rays counted and its output copied back into ``c``:
        what the width's graph holds."""
        live = c.active.sum()
        gs.iters[wp].add_(live > 0)
        gs.rays.add_(live)
        for a, b in zip(c, step(c, wp, rec)):
            a.copy_(b)

    def copies(g: _Graph, wp: int) -> None:
        """The width's ``SYNC_EVERY`` record slots, each with the graphs
        of an armed step's copies into it: before the step, ``before``'s
        fields; after it, the step's own (the graph's ``slot``) and
        ``after``'s."""
        def pre():
            return {"state": gs.states[wp], "q": td.q, "visits": td.visits,
                    "cdfplus": cdfplus}

        def post():
            return dict(g.slot, q_after=td.q, visits_after=td.visits,
                        irr=cdfplus[:, -1])

        def record_slot():
            kept = {}    # tensors of the copies' pools, rewritten by replays

            def copy_before():
                kept.update(_kept(pre()))

            def copy_after():
                kept.update(_kept(post()))
                kept["live"] = kept["state"].active.any()
            return _capture(copy_before), _capture(copy_after), kept
        g.copies = [record_slot() for _ in range(SYNC_EVERY)]

    def capture(wp: int) -> _Graph:
        """The width's step captured (``body``), with its record slots'
        copies in an armed frame: a later frame may arm any width (the
        benchmark's drawn step falls in the second phase once the widest
        shortens), and its warm-up frame is armed."""
        nonlocal captured
        slot = {}
        n0 = TRANSPORT.launches
        with span("trace_frame_sarsa_wavefront.graph_capture"):
            g = _Graph(_capture(lambda: body(gs.states[wp], wp, slot), gen,
                                gs), slot, gs.held)
            if cap is not None:
                copies(g, wp)
        captured += TRANSPORT.launches - n0
        return g

    def replay(g: _Graph, wp: int, k: int, rec: dict | None) -> None:
        """Step ``k`` replayed; if armed, between its record slot's copies,
        the slot copied into an explicit step's record."""
        if rec is None:
            with span("trace_frame_sarsa_wavefront.replay"):
                g.replay()
            return
        if not g.copies:
            with span("trace_frame_sarsa_wavefront.graph_capture"):
                copies(g, wp)
        copy_before, copy_after, kept = g.copies[k % SYNC_EVERY]
        with span("trace_frame_sarsa_wavefront.capture"):
            copy_before()
        with span("trace_frame_sarsa_wavefront.replay"):
            g.replay()
        with span("trace_frame_sarsa_wavefront.capture"):
            copy_after()
            if k in cap.iterations:
                rec.update(_kept(kept))

    widths = _phase_widths(w0, drain_factor, min_drain_w)
    phase_iters = []
    k = 0                     # the frame's steps so far
    replays = captured = 0
    if cap is not None:
        cap.w0 = w0
    for i, wp in enumerate(widths):
        w_next = widths[i + 1] if i + 1 < len(widths) else 0
        iters = no_iters
        n = 0
        while n % SYNC_EVERY or _live_above(st.active, w_next, mesh):
            with span("trace_frame_sarsa_wavefront.step"):
                rec = None if cap is None else cap.want(k, w_next == 0)
                if rec is not None:
                    rec.update(step=k, phase=i, width=wp)
                g = None if gs is None else gs.graph(wp)
                if g is not None:
                    replay(g, wp, k, rec)
                    replays += 1
                else:
                    if gs is None:
                        iters = iters + st.active.any()
                        if counting:
                            rec_.tally("sarsa_wavefront.rays",
                                       st.active.sum())
                    if rec is not None:
                        before(rec, st)
                    if gs is None:
                        st = step(st, wp, rec)
                    else:
                        body(st, wp, rec)
                    if rec is not None:
                        after(rec)
                    if gs is not None:
                        # the width's later steps replay this one
                        gs.graphs[wp] = capture(wp)
            n += 1
            k += 1
        if gs is not None:
            iters = gs.iters[wp]
            if cap is not None and cap.tail and not w_next:
                # the tail's replayed steps, still in their record slots
                with span("trace_frame_sarsa_wavefront.capture"):
                    for rec in cap.tail_records:
                        if "state" not in rec:
                            rec.update(_kept(gs.graphs[wp].copies[
                                rec["step"] % SYNC_EVERY][2]))
        phase_iters.append(iters)
        if w_next:
            with span("trace_frame_sarsa_wavefront.compact"):
                st = _compact(st, wp)
            # the tail [w_next:] is dead (live <= w_next, compacted to the
            # front): flush its banked radiance before slicing it away
            with span("trace_frame_sarsa_wavefront.flush"):
                if cap is not None:
                    cap.flush(st.pixel[w_next:], st.kmx[w_next:],
                              st.slot_rad[w_next:])
                with profiling.host_sync("flush", image, waits=2):
                    _flush(image, st.pixel[w_next:], st.kmx[w_next:],
                           st.slot_rad[w_next:], w0, pix_lo)
                st = _State(*(a[:w_next] for a in st))
                if gs is not None:
                    st = gs.enter(st, w_next)
    with span("trace_frame_sarsa_wavefront.flush"):
        if cap is not None:
            cap.flush(st.pixel, st.kmx, st.slot_rad)
        with profiling.host_sync("flush", image, waits=2):
            _flush(image, st.pixel, st.kmx, st.slot_rad, w0, pix_lo)
    with span("trace_frame_sarsa_wavefront.totals"):
        phase_iters = torch.stack(phase_iters)
        iters = phase_iters.sum()
        if td is not None:
            td_count = td.count
        out_vols, path_sum, zclp = vols, stats["path_sum"], stats["zclp"]
        if gs is not None:
            # what the frame returns outlives the static set's next frame
            # (new names: the captured steps hold the static ones)
            out_vols = dataclasses.replace(vols, q=td.q.clone(),
                                           visits=td.visits.clone())
            path_sum, zclp, td_count = (a.clone() for a in (
                path_sum, zclp, td_count))
            caller_gen.set_state(gen.get_state())
        if counting:
            rec_.counts["sarsa_wavefront.frames"] += 1
            rec_.counts["sarsa_wavefront.steps"] += k
            rec_.counts["sarsa_wavefront.transport_launches"] += (
                TRANSPORT.launches - launches - captured + replays)
            rec_.counts["sarsa_wavefront.td_kernel_steps"] += (
                k if td is not None else 0)
            rec_.counts["sarsa_wavefront.graph_steps"] += replays
            rec_.tally("sarsa_wavefront.iterations", iters)
            if gs is not None:
                rec_.tally("sarsa_wavefront.rays", gs.rays)
    if cap is not None:
        cap.steps = k
    return (image, out_vols, path_sum, zclp, iters, td_count, phase_iters,
            tuple(widths))


def render_frame_sarsa_wavefront(generator_or_seed, scene: Scene,
                                 camera: Camera, vols: RadianceVolumes,
                                 grid, cfg: RenderConfig,
                                 rl: RadianceVolumeConfig,
                                 pix_mux: int = 1, hit_mode: str = "mxu",
                                 sampler: str = "row",
                                 frame_mode: str = "hit",
                                 drain_factor: int = DRAIN_FACTOR,
                                 min_drain_w: int = MIN_DRAIN_W,
                                 cdf_dtype: str = "f32"):
    """Render one frame while learning; returns (image (H, W, 3), vols,
    aux), the CDF rebuilt at the end (ref: main.cu:342-344).  The
    arguments are trace_frame_sarsa_wavefront's.

    aux: avg_path_length, zero_contribution_light_paths,
    wavefront_iterations, td_scatter_count (== the visit-count delta),
    phase_iterations (device tensors) and phase_widths (ints).
    """
    image, vols, path_sum, zclp, iters, td_count, phase_iters, widths = \
        trace_frame_sarsa_wavefront(
            generator_or_seed, scene, camera, vols, grid, cfg, rl,
            pix_mux=pix_mux, hit_mode=hit_mode, sampler=sampler,
            frame_mode=frame_mode, drain_factor=drain_factor,
            min_drain_w=min_drain_w, cdf_dtype=cdf_dtype)
    cap = CAPTURE
    if cap is not None:
        cap.q_final, cap.visits_final = vols.q, vols.visits
    with profiling.span("render_frame_sarsa_wavefront.rebuild"):
        vols = rebuild_cdf(vols, rl.distribution_threshold,
                           rl.defensive_mix)
    if cap is not None:
        cap.cdf = vols.cdf
    with profiling.span("render_frame_sarsa_wavefront.assemble"):
        spp = cfg.samples_per_pixel
        img = (image / spp).reshape(cfg.height, cfg.width, 3)
        aux = {"avg_path_length": path_sum / (cfg.n_pixels * spp),
               "zero_contribution_light_paths": zclp,
               "wavefront_iterations": iters,
               "td_scatter_count": td_count,
               "phase_iterations": phase_iters,
               "phase_widths": widths}
    return img, vols, aux

