"""Observer framework: spectral configs, render engine, observer bases.

Vectorised re-design of raysect/optical/observer/base/{observer,slice,
pipeline,processor,sampler}.pyx. The reference farms per-pixel tasks to
forked workers (SURVEY.md §3.1); here ``observe()`` compiles the scene per
spectral slice, asks the frame sampler for a pixel task list, pads it into
fixed-shape tiles, and runs a jitted wavefront render per tile — optionally
sharded over a ``jax.sharding.Mesh`` (the DP axis is the pixel tile,
SURVEY.md §2.12).

Statistics flow: the device kernel returns per-pixel (sum, sum-of-squares,
count) per pipeline channel; pipelines fold them into host StatsArrays with
the same Welford merge the reference uses (statsarray.pyx combine_samples).
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from ...compiler.scene import SpectralConfig, compile_scene
from ...core.scenegraph.node import Observer as _SceneObserver
from ...tracer.wavefront import RayConfig, init_rays, trace_rays
from ...core.math import batch as vmath
from ..spectrum import Spectrum

__all__ = [
    "SpectralSlice",
    "FrameSampler1D",
    "FrameSampler2D",
    "Pipeline",
    "ObserverBase",
    "Observer0D",
    "Observer1D",
    "Observer2D",
]


class SpectralSlice:
    """A contiguous sub-range of the spectral bins (base/slice.pyx:32)."""

    def __init__(self, min_wavelength, max_wavelength, bins, slice_bins, offset):
        self.total_bins = int(bins)
        self.bins = int(slice_bins)
        self.offset = int(offset)
        delta = (max_wavelength - min_wavelength) / bins
        self.min_wavelength = min_wavelength + delta * offset
        self.max_wavelength = min_wavelength + delta * (offset + slice_bins)

    @property
    def config(self):
        return SpectralConfig(self.min_wavelength, self.max_wavelength, self.bins)


class FrameSampler1D:
    """Task generator contract (base/sampler.pyx:32)."""

    def generate_tasks(self, pixels):
        raise NotImplementedError


class FrameSampler2D:
    def generate_tasks(self, pixels):
        raise NotImplementedError


class Pipeline:
    """Pipeline contract (base/pipeline.pyx:37-254), device formulation.

    Device side: ``project(spectra, consts, sensitivity)`` maps per-sample
    spectra [T, S, slice.bins] -> channel values [T, S, C]. ``consts`` is
    the pytree returned by ``projection_constants(slice_)`` — the per-slice
    values (resampled CIE/filter tables, slice offset) enter the kernel as
    TRACED arguments so every spectral slice shares one compiled kernel.
    Host side: ``initialise/update/finalise`` manage the StatsArray frames.
    """

    name = None

    def n_channels(self, total_bins):
        raise NotImplementedError

    def projection_constants(self, slice_: SpectralSlice):
        """Per-slice traced constants consumed by ``project``."""
        return ()

    def project(self, spectra, consts, sensitivity, px=None, py=None):
        raise NotImplementedError

    def initialise(self, shape, spectral_config, slices, quiet=False):
        raise NotImplementedError

    def update(self, pixel_ids, mean, m2, n):
        """Fold a tile batch of per-pixel channel statistics into the frame.
        pixel_ids: int array of flat pixel indices [T]; mean/m2 [T, C]; n [T]."""
        raise NotImplementedError

    def finalise(self):
        pass


class Pipeline0D(Pipeline):
    """Pipeline for 0D observers (base/pipeline.pyx:37): single spectrum."""


class Pipeline1D(Pipeline):
    """Pipeline for 1D observers (base/pipeline.pyx:110): pixel line."""


class Pipeline2D(Pipeline):
    """Pipeline for 2D observers (base/pipeline.pyx:183): pixel grid."""


class PixelProcessor:
    """Per-task sample accumulator contract (base/processor.pyx:61-72).

    The device path folds samples into per-tile Welford statistics on-chip
    (ObserverBase kernels), so built-in pipelines never instantiate one.
    Custom pipelines written against the reference's processor API are
    fully supported: a pipeline that defines ``pixel_processor(pixel_id,
    slice_id) -> PixelProcessor`` (instead of the device-side ``project``)
    is driven on the host — the observer pulls the traced per-sample slice
    spectra back, calls ``add_sample(spectrum, sensitivity)`` for every
    sample and ``pack_results()`` per pixel, then hands the packed result
    to ``pipeline.update(pixel_id, packed, slice_id)`` (the reference loop,
    base/observer.pyx:363-419)."""

    def add_sample(self, spectrum, sensitivity):
        raise NotImplementedError

    def add_samples(self, min_wavelength, max_wavelength, bins, samples,
                    sensitivity):
        """Fold a whole sample batch [S, bins] for one pixel.

        Override to vectorise a custom processor (one numpy pass instead of
        S python calls). The default drives the reference per-sample
        contract: one host-numpy Spectrum per row through ``add_sample``
        (no device traffic — Spectrum is numpy-backed)."""
        for row in samples:
            self.add_sample(
                Spectrum(min_wavelength, max_wavelength, bins, samples=row),
                sensitivity,
            )

    def pack_results(self):
        raise NotImplementedError


def _uses_pixel_processor(pipe):
    """True for pipelines driven through the reference PixelProcessor API
    (they define ``pixel_processor`` and rely on host-side sample folding)."""
    return callable(getattr(pipe, "pixel_processor", None))


@jax.jit
def _reduce_samples(proj):
    """Per-pixel (sum, sum-of-squares) over the sample axis, on device.

    proj is [T, S, C] per-sample channel projections; returns two [T, C]
    arrays. Keeping this on device means only the reduced sums ever cross
    the host boundary (the reference reduces per-sample spectra inside the
    worker process for the same reason, base/processor.pyx:61-72)."""
    return proj.sum(axis=1), (proj * proj).sum(axis=1)


def _slice_spectrum(min_wavelength, max_wavelength, bins, rays):
    """Reference slicing algorithm (base/observer.pyx:311-340)."""
    current = 0.0
    start = 0
    ranges = []
    while start < bins:
        current += bins / rays
        end = round(current)
        ranges.append((start, end))
        start = end
    return [
        SpectralSlice(min_wavelength, max_wavelength, bins, end - start, start)
        for start, end in ranges
    ]


class ObserverBase(_SceneObserver):
    """Common observer machinery (base/observer.pyx:70-545).

    Subclasses supply:
      _pixel_shape                      — tuple of pixel dims ((,), (n,), (nx, ny))
      _generate_rays_device(px, py, u) — camera-local rays [T, S, 3] x2 + weight [T, S]
      _rays_per_sample                 — uniforms needed per camera sample
      _pixel_sensitivity_array()       — per-pixel sensitivity, flat [n_pixels]
    """

    def __init__(self, parent=None, transform=None, name=None, pipelines=None,
                 render_engine=None):
        super().__init__(parent, transform, name)
        self.pipelines = pipelines or []
        self.render_engine = render_engine  # None -> single-device jit

        # spectral configuration (base/observer.pyx:113-122 defaults)
        self._min_wavelength = 375.0
        self._max_wavelength = 740.0
        self._spectral_bins = 15
        self._spectral_rays = 1

        # ray configuration
        self._ray_extinction_prob = 0.01
        self._ray_extinction_min_depth = 3
        self._ray_max_depth = 500
        self._ray_importance_sampling = True
        self._ray_important_path_weight = 0.25
        # spectral-state storage dtype for the wavefront trace: "float32"
        # (default) or "bfloat16" (halves the dominant per-bounce memory
        # traffic; ~1% per-ray rounding vs ~300% per-ray MC noise on the
        # flagship scene — see RayConfig.spectral_dtype)
        self.ray_spectral_dtype = "float32"

        # sampling configuration
        self.pixel_samples = 100
        self.samples_per_task = 250  # kept for API parity; chunking knob
        self.tile_size = 4096  # pixels per device batch
        self.quiet = False
        self.render_complete = False

        # wavefront loop bound: paths longer than this are truncated; the
        # reference's recursion depth cap is ray_max_depth
        self.max_wavefront_iters = 64
        # stream-compaction schedule for the wavefront loop:
        #   "auto" (default) — measure the per-bounce alive profile on the
        #     first tile of a pass and derive a conservative schedule
        #     (4x headroom, see tracer/wavefront.schedule_from_profile);
        #     falls back to no compaction under a sharded render engine
        #     (the alive-first sort would become a cross-device collective);
        #   ()       — off;
        #   ((steps, divisor), ...) — explicit stages.
        # Overflowed stages reweight (unbiased); the overflow counter is
        # surfaced in the render statistics.
        self.compact_schedule = "auto"

        self._stats_start = None
        self._stats_rays = 0

    # --- validated properties (base/observer.pyx:100-262) -----------------------

    @property
    def spectral_bins(self):
        return self._spectral_bins

    @spectral_bins.setter
    def spectral_bins(self, value):
        if value <= 0:
            raise ValueError("The number of spectral bins must be greater than 0.")
        if value < self._spectral_rays:
            raise ValueError("Spectral bins cannot be less than spectral rays.")
        self._spectral_bins = int(value)

    @property
    def spectral_rays(self):
        return self._spectral_rays

    @spectral_rays.setter
    def spectral_rays(self, value):
        if not 0 < value <= self._spectral_bins:
            raise ValueError("Spectral rays must be in (0, spectral_bins].")
        self._spectral_rays = int(value)

    @property
    def min_wavelength(self):
        return self._min_wavelength

    @min_wavelength.setter
    def min_wavelength(self, value):
        if value <= 0 or value >= self._max_wavelength:
            raise ValueError("Minimum wavelength must be positive and below the maximum.")
        self._min_wavelength = float(value)

    @property
    def max_wavelength(self):
        return self._max_wavelength

    @max_wavelength.setter
    def max_wavelength(self, value):
        if value <= self._min_wavelength:
            raise ValueError("Maximum wavelength must be above the minimum.")
        self._max_wavelength = float(value)

    @property
    def ray_extinction_prob(self):
        return self._ray_extinction_prob

    @ray_extinction_prob.setter
    def ray_extinction_prob(self, value):
        if not 0 <= value <= 1:
            raise ValueError("Extinction probability must be in [0, 1].")
        self._ray_extinction_prob = float(value)

    @property
    def ray_extinction_min_depth(self):
        return self._ray_extinction_min_depth

    @ray_extinction_min_depth.setter
    def ray_extinction_min_depth(self, value):
        if value < 0:
            raise ValueError("Minimum extinction depth cannot be negative.")
        self._ray_extinction_min_depth = int(value)

    @property
    def ray_max_depth(self):
        return self._ray_max_depth

    @ray_max_depth.setter
    def ray_max_depth(self, value):
        if value < 0:
            raise ValueError("Maximum depth cannot be negative.")
        self._ray_max_depth = int(value)

    @property
    def ray_importance_sampling(self):
        return self._ray_importance_sampling

    @ray_importance_sampling.setter
    def ray_importance_sampling(self, value):
        self._ray_importance_sampling = bool(value)

    @property
    def ray_important_path_weight(self):
        return self._ray_important_path_weight

    @ray_important_path_weight.setter
    def ray_important_path_weight(self, value):
        if not 0 <= value <= 1:
            raise ValueError("Important path weight must be in [0, 1].")
        self._ray_important_path_weight = float(value)

    # --- subclass hooks ----------------------------------------------------------

    @property
    def _pixel_shape(self):
        raise NotImplementedError

    def _generate_rays_device(self, px, py, u):
        raise NotImplementedError

    _rays_per_sample = 2

    def _pixel_sensitivity_array(self):
        n = int(np.prod(self._pixel_shape)) if self._pixel_shape else 1
        return np.ones(n, dtype=np.float32)

    def _kernel_cache_extra(self):
        """Extra jit-cache key material for observers whose ray generation
        captures host-side values (e.g. a target sphere position)."""
        return ()

    def _generate_tasks(self):
        raise NotImplementedError

    # --- observe -------------------------------------------------------------------

    def _ray_config(self, schedule=()):
        return RayConfig(
            max_depth=self._ray_max_depth,
            extinction_prob=self._ray_extinction_prob,
            extinction_min_depth=self._ray_extinction_min_depth,
            importance_sampling=self._ray_importance_sampling,
            important_path_weight=self._ray_important_path_weight,
            max_iters=self.max_wavefront_iters,
            compact_schedule=tuple(schedule),
            spectral_dtype=self.ray_spectral_dtype,
        )

    def _resolve_compact_schedule(self, scene, cfg0, px, py, cam_to_world,
                                  spp, key):
        """Resolve ``compact_schedule`` for this pass. "auto" measures the
        per-bounce alive profile on (a subsample of) the first tile and
        derives a conservative staged schedule; the result is cached on the
        observer so accumulation passes reuse one compiled kernel."""
        if self.compact_schedule != "auto":
            return tuple(self.compact_schedule)
        engine = self.render_engine
        if engine is not None and hasattr(engine, "mesh"):
            return ()  # sharded batch axis: compaction sort is a collective
        cache_key = (id(self.root), scene.n_entities, scene.n_leaves,
                     cfg0, scene.n_bins)
        cached = getattr(self, "_auto_schedule_cache", None)
        if cached is not None and cached[0] == cache_key:
            return cached[1]
        from ...tracer.wavefront import alive_profile, schedule_from_profile

        # subsample lanes: the profile only needs fractions
        T = px.shape[0]
        s_meas = max(1, min(spp, 8192 // T if T < 8192 else 1))
        u = jax.random.uniform(key, (T, s_meas, self._rays_per_sample))
        o_loc, d_loc, w = self._generate_rays_device(px[:, None], py[:, None], u)
        o = vmath.transform_point(cam_to_world, o_loc.reshape(-1, 3))
        d = vmath.normalise(
            vmath.transform_vector(cam_to_world, d_loc.reshape(-1, 3))
        )
        state = init_rays(o, d, scene.bins, weight=w.reshape(-1))
        counts = np.asarray(
            jax.jit(alive_profile, static_argnums=1)(scene, cfg0, state, key)
        )
        schedule = schedule_from_profile(counts.tolist(), o.shape[0])
        self._auto_schedule_cache = (cache_key, schedule)
        return schedule

    def observe(self, seed=None):
        """Render a pass (base/observer.pyx:265-309)."""
        if self.root is None or not hasattr(self.root, "primitives"):
            raise RuntimeError("The observer must be attached to a World scenegraph.")
        world = self.root

        slices = _slice_spectrum(
            self._min_wavelength, self._max_wavelength,
            self._spectral_bins, self._spectral_rays,
        )
        scenes = [compile_scene(world, s.config) for s in slices]

        shape = self._pixel_shape
        self._initialise_pipelines(shape, slices)
        # split device pipelines (jit-projected) from reference-API custom
        # pipelines driven through PixelProcessor on the host
        self._dev_pipes = [p for p in self.pipelines if not _uses_pixel_processor(p)]
        self._proc_pipes = [p for p in self.pipelines if _uses_pixel_processor(p)]

        tasks = np.asarray(self._generate_tasks(), dtype=np.int64)
        if tasks.size == 0:
            self.render_complete = True
            return
        self.render_complete = False

        self._initialise_statistics(tasks)
        cfg0 = self._ray_config(())
        cfg = None  # resolved (incl. auto compaction) at the first tile
        key = jax.random.PRNGKey(
            int(seed) if seed is not None else np.random.randint(0, 2**31 - 1)
        )
        cam_to_world = jnp.asarray(self.to_root().to_array(np.float32))
        sensitivity_all = jnp.asarray(self._pixel_sensitivity_array())

        T = int(self.tile_size)
        n_tasks = tasks.shape[0]
        n_tiles = (n_tasks + T - 1) // T
        spp = int(self.pixel_samples)

        # sample chunking (base/observer.pyx:629-644 samples_per_task): a
        # million-sample observation streams in fixed-memory chunks instead
        # of one [T, spp] device batch. Equal-size chunks share the compiled
        # kernel; at most one remainder chunk adds a second compile.
        spt = int(self.samples_per_task or spp)
        spt = max(1, min(spt, spp))
        sample_chunks = [spt] * (spp // spt)
        if spp % spt:
            sample_chunks.append(spp % spt)

        deferred_tiles = []
        deferred_segs = []
        deferred_ovfs = []
        for tile_idx in range(n_tiles):
            chunk = tasks[tile_idx * T:(tile_idx + 1) * T]
            # pad to the next power of two (min 8, for device divisibility),
            # NOT to the full tile size — a 0D observer's single task must
            # not explode into tile_size copies of itself
            t_eff = 8
            while t_eff < chunk.shape[0]:
                t_eff *= 2
            t_eff = min(T, t_eff)
            pad = t_eff - chunk.shape[0]
            valid = np.ones(t_eff, dtype=bool)
            if pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
                valid[-pad:] = False
            flat_ids = self._task_to_flat(chunk)
            px, py = self._task_to_pixel_coords(chunk)
            tile_key = jax.random.fold_in(key, tile_idx)
            sens = sensitivity_all[jnp.asarray(flat_ids)]
            pxj, pyj = jnp.asarray(px), jnp.asarray(py)
            if cfg is None:
                schedule = self._resolve_compact_schedule(
                    scenes[0], cfg0, pxj, pyj, cam_to_world, spt,
                    jax.random.fold_in(key, 0x5EED),
                )
                cfg = self._ray_config(schedule)

            # accumulate per-pixel (sum, sum-of-squares) over sample chunks;
            # per chunk, slices sum into the full per-sample spectrum first.
            # Reductions stay ON DEVICE ([T, S, C] never crosses to host —
            # only the [T, C] sums do, once per tile) and segment counters
            # stay device scalars so XLA queues every chunk kernel without a
            # host sync in between.
            acc_sum = acc_sq = None
            seg_acc = deferred_segs
            ovf_acc = deferred_ovfs
            proc_spectra = [[] for _ in slices]  # host per-slice sample spectra
            for c_idx, s_chunk in enumerate(sample_chunks):
                proj_sums = None
                for s_idx, (slice_, scene) in enumerate(zip(slices, scenes)):
                    out = self._render_tile(
                        scene, cfg, slice_, pxj, pyj, sens, cam_to_world,
                        s_chunk,
                        jax.random.fold_in(tile_key, c_idx * 8191 + s_idx),
                    )
                    if self._proc_pipes:
                        projections, spectra, segments, overflow = out
                        proc_spectra[s_idx].append(np.asarray(spectra))
                    else:
                        projections, segments, overflow = out
                    seg_acc.append(segments)
                    ovf_acc.append(overflow)
                    # each pipeline projects to its FULL channel count
                    # (spectral pipelines zero-fill outside the slice), so
                    # slices just sum
                    if proj_sums is None:
                        proj_sums = list(projections)
                    else:
                        for i, p in enumerate(projections):
                            proj_sums[i] = proj_sums[i] + p
                if acc_sum is None:
                    acc_sum = [0.0] * len(proj_sums)
                    acc_sq = [0.0] * len(proj_sums)
                for i, proj in enumerate(proj_sums):
                    s1, s2 = _reduce_samples(proj)  # device [T, C] pair
                    acc_sum[i] = acc_sum[i] + s1
                    acc_sq[i] = acc_sq[i] + s2

            # reference-API custom pipelines: drive PixelProcessor per pixel
            # per slice with the full sample set (base/observer.pyx:363-419).
            # The sample axis folds through the BATCHED add_samples hook —
            # per-pixel python boundary only; the default implementation
            # loops numpy-backed Spectrums with zero device traffic
            if self._proc_pipes:
                sens_np = np.asarray(sens)
                for s_idx, slice_ in enumerate(slices):
                    sp = np.asarray(
                        np.concatenate(proc_spectra[s_idx], axis=1),
                        dtype=np.float64,
                    )  # [T, spp, b]
                    for pipe in self._proc_pipes:
                        for t in range(sp.shape[0]):
                            if not valid[t]:
                                continue
                            proc = pipe.pixel_processor(int(flat_ids[t]), s_idx)
                            proc.add_samples(
                                slice_.min_wavelength, slice_.max_wavelength,
                                slice_.bins, sp[t], float(sens_np[t]),
                            )
                            pipe.update(int(flat_ids[t]), proc.pack_results(), s_idx)

            # DEFER the per-pixel statistics pull: every device->host read
            # waits for the device, so per-tile np.asarray/int() syncs would
            # stall the queue between tiles. All tiles' device sums are
            # pulled in ONE batched device_get after the loop. Live
            # progress: a dispatch counter prints here with NO device sync;
            # the rays/s statistic waits for the batched pull.
            deferred_tiles.append((flat_ids, valid, list(acc_sum),
                                   list(acc_sq)))
            if not self.quiet:
                print(
                    f"  tile {len(deferred_tiles)}/{n_tiles} dispatched - "
                    f"{time.time() - self._stats_start:0.2f}s",
                    flush=True,
                )

        if deferred_tiles:
            cat_sum = [
                jnp.concatenate([t[2][i] for t in deferred_tiles])
                for i in range(len(self._dev_pipes))
            ]
            cat_sq = [
                jnp.concatenate([t[3][i] for t in deferred_tiles])
                for i in range(len(self._dev_pipes))
            ]
            seg_all = jnp.stack(deferred_segs) if deferred_segs else jnp.zeros(1, jnp.int32)
            ovf_all = jnp.stack(deferred_ovfs) if deferred_ovfs else jnp.zeros(1, jnp.int32)
            host_sum, host_sq, host_seg, host_ovf = jax.device_get(
                (cat_sum, cat_sq, seg_all, ovf_all))
            self._stats_rays += int(np.sum(host_seg))
            self._stats_overflow += int(np.sum(host_ovf))
            off = 0
            for tile_idx, (flat_ids, valid, sums, _sqs) in enumerate(
                    deferred_tiles):
                t_eff = valid.shape[0]
                for pipe, v_sum, v_sq in zip(
                        self._dev_pipes,
                        (h[off:off + t_eff] for h in host_sum),
                        (h[off:off + t_eff] for h in host_sq)):
                    v_sum = np.asarray(v_sum, dtype=np.float64)
                    v_sq = np.asarray(v_sq, dtype=np.float64)
                    mean = v_sum / spp
                    m2 = v_sq - spp * mean * mean
                    np.maximum(m2, 0.0, out=m2)  # guard f.p. cancellation
                    n = np.full(mean.shape[:1], spp, dtype=np.int64)
                    pipe.update(flat_ids[valid], mean[valid], m2[valid],
                                n[valid])
                off += t_eff
                self._update_statistics(tile_idx, n_tiles)

        self._finalise_pipelines()
        self._finalise_statistics()

    # --- device kernel ---------------------------------------------------------------

    def _render_tile(self, scene, cfg, slice_, px, py, sensitivity, cam_to_world,
                     spp, key):
        """Trace one pixel tile for one spectral slice; returns per-pipeline
        per-sample projections and the traced segment count.

        Spectral slices SHARE one compiled kernel: the slice's wavelength
        range rides in as traced data (scene.wavelengths, the pipelines'
        projection_constants), so a 32-spectral-ray dispersion render costs
        at most two compiles (slices can differ by one bin), not 32
        (reference semantics base/observer.pyx:311-340 with XLA reuse)."""
        projections = tuple(getattr(self, "_dev_pipes", self.pipelines))
        want_spectra = bool(getattr(self, "_proc_pipes", ()))
        bins = slice_.bins

        def kernel(scene, px, py, sensitivity, cam_to_world, key, consts):
            T = px.shape[0]
            u = jax.random.uniform(key, (T, spp, self._rays_per_sample))
            o_loc, d_loc, w = self._generate_rays_device(
                px[:, None], py[:, None], u
            )
            o = vmath.transform_point(cam_to_world, o_loc.reshape(-1, 3))
            d = vmath.normalise(vmath.transform_vector(cam_to_world, d_loc.reshape(-1, 3)))
            state = init_rays(o, d, bins, weight=w.reshape(-1),
                              spectral_dtype=cfg.spectral_dtype)
            final = trace_rays(scene, cfg, state, jax.random.fold_in(key, 7))
            # statistics accumulate in f32 regardless of the trace state
            # dtype (bf16 sums over the sample axis would round badly)
            spectra = final.radiance.astype(jnp.float32).reshape(T, spp, bins)
            outs = tuple(
                pipe.project(spectra, c, sensitivity, px, py)
                for pipe, c in zip(projections, consts)
            )
            if want_spectra:
                return outs, spectra, final.segments, final.overflow
            return outs, final.segments, final.overflow

        if not hasattr(self, "_kernel_cache"):
            self._kernel_cache = {}
        cache_key = (id(type(self)), bins, self._spectral_bins, spp, cfg,
                     tuple(id(p) for p in projections), want_spectra,
                     self._kernel_cache_extra())
        fn = self._kernel_cache.get(cache_key)
        if fn is None:
            engine = self.render_engine
            if engine is not None and hasattr(engine, "mesh"):
                # DP-shard the pixel-tile axis over the engine's device mesh
                # via shard_map (SURVEY.md §2.12: pixel tiles are the
                # data-parallel axis; scene tables replicate). shard_map —
                # not jit auto-sharding — so each device runs the FULL
                # production tracer on its local tile shard; per-shard RNG
                # is fold_in(key, axis_index), segment counters psum.
                from jax.sharding import PartitionSpec as P

                ax = engine.axis_name
                tile, repl = P(ax), P()

                def local(scene, px, py, sensitivity, cam_to_world, key,
                          consts):
                    key = jax.random.fold_in(key, jax.lax.axis_index(ax))
                    out = kernel(scene, px, py, sensitivity, cam_to_world,
                                 key, consts)
                    if want_spectra:
                        outs, spectra, segs, ovf = out
                        return (outs, spectra, jax.lax.psum(segs, ax),
                                jax.lax.psum(ovf, ax))
                    outs, segs, ovf = out
                    return (outs, jax.lax.psum(segs, ax),
                            jax.lax.psum(ovf, ax))

                out_specs = ((tile, tile, repl, repl) if want_spectra
                             else (tile, repl, repl))
                fn = jax.jit(jax.shard_map(
                    local, mesh=engine.mesh, check_vma=False,
                    in_specs=(repl, tile, tile, tile, repl, repl, repl),
                    out_specs=out_specs))
            else:
                fn = jax.jit(kernel)
            self._kernel_cache[cache_key] = fn
        consts = tuple(pipe.projection_constants(slice_) for pipe in projections)
        return fn(scene, px, py, sensitivity, cam_to_world, key, consts)

    # --- pipeline + statistics plumbing ------------------------------------------------

    def _initialise_pipelines(self, shape, slices):
        spectral_config = SpectralConfig(
            self._min_wavelength, self._max_wavelength, self._spectral_bins
        )
        for pipe in self.pipelines:
            pipe.initialise(shape, spectral_config, slices, quiet=self.quiet)

    def _finalise_pipelines(self):
        for pipe in self.pipelines:
            pipe.finalise()

    def _initialise_statistics(self, tasks):
        self._stats_start = time.time()
        self._stats_rays = 0
        self._stats_overflow = 0
        if not self.quiet:
            print(f"{self.name or type(self).__name__}: observing, "
                  f"{tasks.shape[0]} tasks x {self.pixel_samples} samples "
                  f"x {self._spectral_rays} spectral rays")

    def _update_statistics(self, tile_idx, n_tiles):
        if not self.quiet:
            elapsed = time.time() - self._stats_start
            print(
                f"  tile {tile_idx + 1}/{n_tiles} - {elapsed:0.2f}s "
                f"({1e-3 * self._stats_rays / max(elapsed, 1e-9):0.1f}k rays/s)",
                flush=True,
            )

    def _finalise_statistics(self):
        elapsed = time.time() - self._stats_start
        self.render_time = elapsed
        self.rays_per_second = self._stats_rays / max(elapsed, 1e-9)
        self.compaction_overflow = self._stats_overflow
        if not self.quiet:
            print(
                f"Render complete - time elapsed {elapsed:0.3f}s - "
                f"{1e-3 * self.rays_per_second:0.1f}k rays/s"
            )
            if self._stats_overflow:
                print(
                    f"  note: {self._stats_overflow} alive lanes exceeded a "
                    "compaction stage and were roulette-reweighted (unbiased,"
                    " extra variance) - loosen compact_schedule divisors"
                )

    # --- task helpers ----------------------------------------------------------------

    def _task_to_flat(self, tasks):
        raise NotImplementedError

    def _task_to_pixel_coords(self, tasks):
        raise NotImplementedError


class Observer0D(ObserverBase):
    """Single-sensor observer (base/observer.pyx:547)."""

    @property
    def _pixel_shape(self):
        return ()

    def _generate_tasks(self):
        return np.zeros((1, 1), dtype=np.int64)

    def _task_to_flat(self, tasks):
        return np.zeros(tasks.shape[0], dtype=np.int64)

    def _task_to_pixel_coords(self, tasks):
        z = np.zeros(tasks.shape[0], dtype=np.int64)
        return z, z


class Observer1D(ObserverBase):
    """Line of pixels (base/observer.pyx:717)."""

    def __init__(self, pixels=1, frame_sampler=None, **kwargs):
        super().__init__(**kwargs)
        self.pixels = int(pixels)
        self.frame_sampler = frame_sampler

    @property
    def _pixel_shape(self):
        return (self.pixels,)

    def _generate_tasks(self):
        if self.frame_sampler is not None:
            tasks = self.frame_sampler.generate_tasks((self.pixels,))
            return np.asarray([(t[0] if isinstance(t, tuple) else t,) for t in tasks], dtype=np.int64).reshape(-1, 1)
        return np.arange(self.pixels, dtype=np.int64).reshape(-1, 1)

    def _task_to_flat(self, tasks):
        return tasks[:, 0]

    def _task_to_pixel_coords(self, tasks):
        return tasks[:, 0], np.zeros(tasks.shape[0], dtype=np.int64)


class Observer2D(ObserverBase):
    """2D pixel-array observer (base/observer.pyx:896)."""

    def __init__(self, pixels=(64, 64), frame_sampler=None, **kwargs):
        super().__init__(**kwargs)
        self.pixels = tuple(int(v) for v in pixels)
        self.frame_sampler = frame_sampler

    @property
    def _pixel_shape(self):
        return self.pixels

    def _generate_tasks(self):
        if self.frame_sampler is not None:
            tasks = self.frame_sampler.generate_tasks(self.pixels)
            return np.asarray(tasks, dtype=np.int64).reshape(-1, 2)
        nx, ny = self.pixels
        xs, ys = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
        return np.stack([xs.ravel(), ys.ravel()], axis=1)

    def _task_to_flat(self, tasks):
        return tasks[:, 0] * self.pixels[1] + tasks[:, 1]

    def _task_to_pixel_coords(self, tasks):
        return tasks[:, 0], tasks[:, 1]
