"""Multi-device execution: view-data-parallel training and tile-sharded
rendering over a ``jax.sharding.Mesh``.

The reference is strictly single-device (one WebGPU queue in one browser
tab; SURVEY.md section 2.3), so this subsystem is new surface: 1M+
Gaussians, multi-view batched rendering with tile-sharded rasterization
across the cards of one host.  The mesh is flat: every card reaches every
other at the same rate, and XLA hands the collectives to NCCL.

* ``dp_train_step``: the scene and optimizer state are replicated; the view
  batch (cameras + target images) is sharded over the ``dp`` mesh axis.
  Each device accumulates parameter gradients and per-Gaussian visibility
  counts over its local views, gradients are ``psum``-reduced, and the
  (identical) Adam update runs everywhere.

* ``render_tile_sharded``: each device renders a horizontal band of tile
  rows.  Projection is computed replicated (O(N) and cheap next to
  rasterization); per-band binning restricts every Gaussian's tile rect to
  the band and rebases tile ids, and splat centers are shifted into band
  pixel coordinates so the rasterizer kernel needs no changes.  The output
  image is sharded over rows; an ``all_gather`` materializes the full frame.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from webdgs.config import DEFAULT_SETTINGS, RenderSettings
from webdgs.core.camera import Camera
from webdgs.core.scene import GaussianScene
from webdgs.ops import binning as binning_ops
from webdgs.ops import rasterize as raster_ops
from webdgs.ops.adam import AdamHyperparameters, AdamState, adam_step
from webdgs.ops.loss import LossConfig, loss_metrics, ssim_map
from webdgs.ops.projection import project_gaussians, restrict_aux_to_band
from webdgs.train.step import _apply_grad_parity, compute_param_grads


def make_mesh(devices=None, axis_name: str = "dp") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


# ---------------------------------------------------------------------------
# data-parallel training over views
# ---------------------------------------------------------------------------

def dp_train_step(scene: GaussianScene, opt_state: AdamState,
                  cameras: Camera, targets: jax.Array, mesh: Mesh, *,
                  img_w: int, img_h: int,
                  loss_cfg: LossConfig = LossConfig(),
                  hp: AdamHyperparameters = AdamHyperparameters(),
                  settings: RenderSettings = DEFAULT_SETTINGS,
                  entry_capacity: int | None = None):
    """One training step over a batch of views sharded across the mesh.

    cameras: stacked Camera pytree with leading view axis (size divisible by
    the mesh); targets: (V, H, W, 3).

    Returns (scene, opt_state, metrics) where metrics carries the same keys
    as the single-device ``train_step`` — scalar losses averaged over the
    view batch, ``visible``/``tile_entries`` as the per-view MAX (the
    quantity that sizes the adaptive entry capacity).
    """
    n_views = targets.shape[0]
    axis = mesh.axis_names[0]

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis)),
        out_specs=(P(), P(), P()), check_vma=False)
    def step(scene_r, opt_r, cams_l, targets_l):
        params = scene_r.params()
        zeros = jax.tree.map(jnp.zeros_like, params)
        n = scene_r.capacity

        def body(carry, inputs):
            grads_acc, counts_acc, sums, maxes = carry
            cam, target = inputs
            image, d_params, aux, demand = compute_param_grads(
                scene_r, cam, target, img_w, img_h, loss_cfg, settings,
                parity_sh=not hp.full_sh, entry_capacity=entry_capacity)
            m = loss_metrics(image, target, loss_cfg)
            grads_acc = jax.tree.map(jnp.add, grads_acc, d_params)
            counts_acc = counts_acc + aux.num_tiles
            sums = {k: sums[k] + m[k] for k in sums}
            maxes = {
                "visible": jnp.maximum(
                    maxes["visible"], jnp.sum(aux.visible.astype(jnp.int32))),
                # post-cull pre-drop demand (see Binning.expansion_entries)
                "tile_entries": jnp.maximum(maxes["tile_entries"], demand),
            }
            return (grads_acc, counts_acc, sums, maxes), None

        sums0 = {k: jnp.float32(0.0)
                 for k in ("loss", "l1", "l2", "dssim", "psnr")}
        maxes0 = {"visible": jnp.int32(0), "tile_entries": jnp.int32(0)}
        (grads, counts, sums, maxes), _ = jax.lax.scan(
            body, (zeros, jnp.zeros((n,), jnp.int32), sums0, maxes0),
            (cams_l, targets_l))

        grads = jax.lax.psum(grads, axis)
        counts = jax.lax.psum(counts, axis)
        metrics = {k: jax.lax.psum(v, axis) / n_views
                   for k, v in sums.items()}
        metrics.update({k: jax.lax.pmax(v, axis) for k, v in maxes.items()})
        grads = jax.tree.map(lambda gr: gr / n_views, grads)

        new_params, new_opt = adam_step(params, grads, opt_r, hp, counts)
        return scene_r.with_params(new_params), new_opt, metrics

    return step(scene, opt_state, cameras, targets)


# ---------------------------------------------------------------------------
# tile-sharded rendering
# ---------------------------------------------------------------------------

def render_tile_sharded(scene: GaussianScene, camera: Camera, img_w: int,
                        img_h: int, mesh: Mesh,
                        settings: RenderSettings = DEFAULT_SETTINGS,
                        gather: bool = True):
    """Render with the tile grid row-sharded across the mesh."""
    axis = mesh.axis_names[0]
    d = mesh.devices.size
    ntx, nty = binning_ops.tile_grid(img_w, img_h, settings)
    nty_pad = -(-nty // d) * d
    rows = nty_pad // d
    band_h = rows * settings.tile_h

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(P(),),
                       out_specs=P(axis), check_vma=False)
    def run(scene_r):
        b = jax.lax.axis_index(axis)
        row0 = b * rows
        attrs, aux = project_gaussians(scene_r.params(), scene_r.alive,
                                       camera, img_w, img_h, scene_r.sh_deg,
                                       settings)
        aux_b = restrict_aux_to_band(aux, row0, rows)
        # shift splat centers into band pixel coordinates so the kernel's
        # tile->pixel mapping stays band-local
        shift = jnp.array([0.0, 1.0]) * (row0 * settings.tile_h)
        attrs_b = attrs._replace(
            center_px=attrs.center_px - shift[None, :].astype(jnp.float32))

        # full capacity per band: a concentrated scene can land all its
        # entries in one band (dividing by D would silently drop them).
        # Forward-only: skip the gradient path's sort payload.
        bins = binning_ops.bin_splats(aux_b, img_w, band_h, settings)
        attrs16 = raster_ops.pack_entry_attrs(attrs_b, bins.entry_gauss,
                                              bins.entry_valid)
        out = raster_ops.rasterize_tiles(attrs16, bins.tile_offsets, ntx,
                                         rows, settings)
        tiles = raster_ops.tiles_to_image(out, ntx, rows, img_w, band_h,
                                          settings)
        # (band_h, W, 3), stacked over the mesh by out_specs
        return raster_ops.composite_background(tiles, settings)

    img = run(scene)  # (nty_pad*tile_h, W, 3) row-sharded
    if gather:
        img = jax.device_get(img)
    return img[:img_h] if gather else img


# ---------------------------------------------------------------------------
# gaussian-sharded rendering with entry all-to-all
# ---------------------------------------------------------------------------

def render_gaussian_sharded(scene: GaussianScene, camera: Camera,
                            img_w: int, img_h: int, mesh: Mesh,
                            settings: RenderSettings = DEFAULT_SETTINGS,
                            send_capacity: int | None = None,
                            gather: bool = True):
    """Scale-out render: the Gaussian axis is sharded across the mesh and
    tile entries are exchanged to their band owners.

    Each device projects and expands only its N/D Gaussians (O(N/D) work and
    memory — ``render_tile_sharded`` replicates both), sorts its local
    entries by the global tile key, slices them into per-band blocks, and one
    ``all_to_all`` delivers every band's entries to its owner, which merges
    them into one sorted run and rasterizes its tile rows.  Per-device entry memory is
    O(E/D * slack) instead of O(E).

    ``send_capacity``: per-destination-band entry budget each device may
    send (default 2x the uniform share, chunk-rounded).  A band more
    concentrated than the slack drops the overflow — the same
    degrade-under-budget semantics as the reference's maxTileEntries
    (tiled-forward-pass.ts:137-158).  The dropped-entry count is returned
    so callers can grow the budget adaptively like the Trainer's entry
    capacity.

    Returns (image, dropped) — dropped is a scalar int array.
    """
    axis = mesh.axis_names[0]
    d = mesh.devices.size
    chunk = settings.chunk
    if scene.capacity % d != 0:
        raise ValueError(
            f"scene capacity {scene.capacity} not divisible by mesh size "
            f"{d}; pad_to a multiple first")
    ntx, nty = binning_ops.tile_grid(img_w, img_h, settings)
    binning_ops.check_tile_key_limit(ntx * (-(-nty // d) * d))
    nty_pad = -(-nty // d) * d
    rows = nty_pad // d
    band_h = rows * settings.tile_h
    band_tiles = ntx * rows

    n_loc = scene.capacity // d
    e_loc = binning_ops.entry_capacity(n_loc, settings)
    if send_capacity is None:
        send_capacity = min(-(-2 * (e_loc // max(d, 1)) // chunk) * chunk,
                            e_loc)
    s_cap = max(-(-send_capacity // chunk) * chunk, chunk)
    recv = d * s_cap

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(P(axis),),
                       out_specs=(P(axis), P()), check_vma=False)
    def run(scene_l):
        b = jax.lax.axis_index(axis)
        attrs, aux = project_gaussians(scene_l.params(), scene_l.alive,
                                       camera, img_w, img_h, scene_l.sh_deg,
                                       settings)
        # the tile cull is per-Gaussian, so it shards cleanly over the
        # gaussian axis: culled pairs are never packed or exchanged
        # (image-identical, same guarantee as the single-device path)
        key, g, _, _, _, _ = binning_ops.expand_entries(
            aux, ntx, e_loc, attrs=attrs, settings=settings)
        skey, sg = jax.lax.sort((key, g), num_keys=1)

        # sorted by tile => grouped by destination band (bands are
        # contiguous tile-row blocks); per-band slices via searchsorted
        band_bound_keys = (jnp.arange(d + 1, dtype=jnp.uint32)
                           * jnp.uint32(band_tiles)) << 16
        bounds = jnp.searchsorted(skey, band_bound_keys).astype(jnp.int32)
        band_off = bounds[:-1]
        band_cnt = bounds[1:] - bounds[:-1]
        dropped_local = jnp.sum(jnp.maximum(band_cnt - s_cap, 0))

        # send buffer (d, s_cap): block b goes to device b
        slot = jnp.arange(d * s_cap, dtype=jnp.int32)
        sb = slot // s_cap
        j = slot % s_cap
        src = jnp.clip(band_off[sb] + j, 0, e_loc - 1)
        s_valid = j < band_cnt[sb]
        send_keys = jnp.where(s_valid, skey[src], jnp.uint32(0xFFFFFFFF))
        per_g = raster_ops._pack_per_gauss(attrs)  # (n_loc, NUM_ROWS)
        send_rows = jnp.where(s_valid[:, None], per_g[sg[src]], 0.0)
        send_rows = _encode_exchange(send_rows, send_keys, s_valid, ntx,
                                     settings)

        keys_r = jax.lax.all_to_all(
            send_keys.reshape(d, s_cap), axis, 0, 0).reshape(recv)
        rows_r = jax.lax.all_to_all(
            send_rows.reshape(d, s_cap, raster_ops.NUM_ROWS), axis, 0, 0
        ).reshape(recv, raster_ops.NUM_ROWS)

        # merge the d sorted runs (one sort; keys are globally unique enough
        # — equal keys may reorder, same as the reference's radix ties);
        # the merged order is the band's entry layout
        mkey, perm = jax.lax.sort(
            (keys_r, jnp.arange(recv, dtype=jnp.int32)), num_keys=1)
        tile_offsets, valid = _band_tile_ranges(mkey, b, band_tiles)

        shift = (b * rows * settings.tile_h).astype(jnp.float32)
        entry_rows = _decode_exchange(rows_r[perm], mkey, valid, ntx, shift,
                                      settings)
        attrs16 = entry_rows.T

        out = raster_ops.rasterize_tiles(attrs16, tile_offsets, ntx, rows,
                                         settings)
        tiles = raster_ops.tiles_to_image(out, ntx, rows, img_w, band_h,
                                          settings)
        img_band = raster_ops.composite_background(tiles, settings)
        dropped = jax.lax.psum(dropped_local, axis)
        return img_band, dropped

    img, dropped = run(scene)  # (nty_pad*tile_h, W, 3) row-sharded
    if gather:
        img = jax.device_get(img)
        return img[:img_h], dropped
    return img, dropped


def _band_tile_ranges(mkey: jax.Array, band: jax.Array, band_tiles: int):
    """Tile ranges of one band's merged, key-sorted received entries:
    (tile_offsets (band_tiles+1,), valid (recv,)).  Every received key
    belongs to this band, and empty send slots carry the all-ones key, which
    sorts last."""
    tile0 = band.astype(jnp.uint32) * jnp.uint32(band_tiles)
    tile_offsets = jnp.searchsorted(
        mkey, (tile0 + jnp.arange(band_tiles + 1, dtype=jnp.uint32))
        << 16).astype(jnp.int32)
    valid = jnp.arange(mkey.shape[0]) < tile_offsets[-1]
    return tile_offsets, valid


def _tile_origins(keys: jax.Array, ntx: int, settings: RenderSettings):
    """(x0, y0) pixel origin of each entry's GLOBAL tile (from the sort
    key's tile field, key >> 16)."""
    tile = (keys >> 16).astype(jnp.int32)
    tx0 = ((tile % ntx) * settings.tile_w).astype(jnp.float32)
    ty0 = ((tile // ntx) * settings.tile_h).astype(jnp.float32)
    return tx0, ty0


def _encode_exchange(rows: jax.Array, keys: jax.Array, valid: jax.Array,
                     ntx: int, settings: RenderSettings) -> jax.Array:
    """Tile-relative f16 encoding of packed entry rows for the entry
    exchange (halves all_to_all bytes).  Centers (rows 0/1) are rebased to
    the entry's tile origin so the f16 mantissa covers sub-pixel detail at
    any frame size — the f16 class the reference stores all splat
    attributes in.  No-op (f32 pass-through) unless settings.exchange_f16.
    """
    if not settings.exchange_f16:
        return rows
    tx0, ty0 = _tile_origins(keys, ntx, settings)
    rows = rows.at[:, 0].add(jnp.where(valid, -tx0, 0.0))
    rows = rows.at[:, 1].add(jnp.where(valid, -ty0, 0.0))
    return rows.astype(jnp.float16)


def _decode_exchange(rows: jax.Array, keys: jax.Array, valid: jax.Array,
                     ntx: int, shift: jax.Array,
                     settings: RenderSettings) -> jax.Array:
    """Inverse of :func:`_encode_exchange` for gathered entry rows, folding
    in the band pixel-space shift (centers come out in BAND coordinates:
    global y minus ``shift``).  Invalid slots come out all-zero."""
    rows = jnp.where(valid[:, None], rows.astype(jnp.float32), 0.0)
    if settings.exchange_f16:
        tx0, ty0 = _tile_origins(keys, ntx, settings)
        rows = rows.at[:, 0].add(jnp.where(valid, tx0, 0.0))
        rows = rows.at[:, 1].add(jnp.where(valid, ty0 - shift, 0.0))
    else:
        rows = rows.at[:, 1].add(jnp.where(valid, -shift, 0.0))
    return rows


# ---------------------------------------------------------------------------
# fully-sharded training: gaussian-axis-sharded scene AND optimizer
# ---------------------------------------------------------------------------

def gs_train_step(scene: GaussianScene, opt_state: AdamState,
                  camera: Camera, target: jax.Array, mesh: Mesh, *,
                  img_w: int, img_h: int,
                  loss_cfg: LossConfig = LossConfig(),
                  hp: AdamHyperparameters = AdamHyperparameters(),
                  settings: RenderSettings = DEFAULT_SETTINGS,
                  send_capacity: int | None = None,
                  entry_capacity: int | None = None,
                  parity_sh: bool = True):
    """One training step with the scene AND optimizer state sharded over
    the Gaussian axis (1M+ splats beyond one card's params+moments
    memory).

    ``entry_capacity``: per-device expansion capacity override (the
    adaptive analogue of the single-device Trainer's entry cap); defaults
    to the static per-shard heuristic.  ``send_capacity``: per-destination-
    band entry budget.  The returned metrics carry the observations an
    adaptive caller needs: ``entries_local_max`` (largest per-device entry
    count) and ``send_max`` (largest single (device, band) send), mirroring
    the reference's maxTileEntries-driven resize
    (src/renderers/tiled-forward-pass.ts:137-158).

    Forward: each device projects/expands its N/D Gaussians and one
    ``all_to_all`` carries packed entry rows to their tile-band owners,
    which rasterize their rows (as in :func:`render_gaussian_sharded`).
    The per-pixel loss cotangent is computed band-locally with a
    2-pixel-row halo ppermute from the neighbor bands (the 5x5 DSSIM
    window support) — O(H*W/D) loss work per device; the
    backward pass then flows through the *transpose* of the exchange —
    autodiff of ``all_to_all`` routes every entry cotangent back to the
    device that owns its Gaussian, so parameter gradients, Adam moments,
    and the update are fully local.  No gradient psum exists anywhere:
    each Gaussian is owned exactly once (ZeRO-style sharded optimizer for
    free, vs the reference's single-GPU adam.wgsl).

    Returns (scene, opt_state, metrics) with the same metrics surface as
    ``train_step`` (loss/psnr/... as band partial sums + one psum —
    identical on every device; ``visible``/``tile_entries`` are global
    psums).

    **2D mesh (dp x band)**: with a two-axis mesh ``Mesh(devs.reshape(V,B),
    ("dp", "band"))``, pass a stacked camera/target batch of V views.  The
    scene/optimizer shard over "band" (replicated over "dp"); each dp row
    trains its own view band-sharded, and one parameter-gradient ``psum``
    over the small "dp" axis (O(N/B) bytes) averages the batch — the 2D
    composition of the reference's single-view step at config-5 scale.
    """
    if len(mesh.axis_names) == 2:
        dp_axis, axis = mesh.axis_names
        n_views = mesh.shape[dp_axis]
        d = mesh.shape[axis]
        if target.shape[0] != n_views:
            raise ValueError(
                f"2D mesh expects a view batch of {n_views}, got "
                f"{target.shape[0]}")
    else:
        dp_axis = None
        axis = mesh.axis_names[0]
        n_views = 1
        d = mesh.devices.size
    chunk = settings.chunk
    if scene.capacity % d != 0:
        raise ValueError(
            f"scene capacity {scene.capacity} not divisible by the band "
            f"axis size {d}; pad_to a multiple first")
    ntx, nty = binning_ops.tile_grid(img_w, img_h, settings)
    nty_pad = -(-nty // d) * d
    binning_ops.check_tile_key_limit(ntx * nty_pad)
    rows = nty_pad // d
    band_h = rows * settings.tile_h
    band_tiles = ntx * rows

    n_loc = scene.capacity // d
    e_loc = (entry_capacity if entry_capacity is not None
             else binning_ops.entry_capacity(n_loc, settings))
    e_loc = max(-(-e_loc // chunk) * chunk, chunk)
    if send_capacity is None:
        send_capacity = min(-(-2 * (e_loc // max(d, 1)) // chunk) * chunk,
                            e_loc)
    s_cap = max(-(-send_capacity // chunk) * chunk, chunk)
    recv = d * s_cap

    from webdgs.ops.projection import project_gaussians as _project

    state_specs = AdamState(m=P(axis), v=P(axis), iteration=P())

    cam_spec = P(dp_axis) if dp_axis else P()
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis), state_specs, cam_spec, cam_spec),
        out_specs=(P(axis), state_specs, P()), check_vma=False)
    def step(scene_l, opt_l, cam, tgt):
        if dp_axis:  # local slice of the view batch has a leading 1
            cam = jax.tree.map(lambda x: x[0], cam)
            tgt = tgt[0]
        b = jax.lax.axis_index(axis)
        params_l = scene_l.params()

        def proj_fn(p):
            return _project(p, scene_l.alive, cam, img_w, img_h,
                            scene_l.sh_deg, settings,
                            detach_color=parity_sh)

        attrs, vjp_proj, aux = jax.vjp(proj_fn, params_l, has_aux=True)

        # ---- non-differentiable index plumbing (from aux, as in the
        # single-device split: binning is data, not differentiated; the
        # per-Gaussian tile cull shards cleanly and is detached inside
        # _cull_bitmask) ----
        key, g, _, _, _, demand = binning_ops.expand_entries(
            aux, ntx, e_loc, attrs=attrs, settings=settings)
        skey, sg = jax.lax.sort((key, g), num_keys=1)
        band_bound_keys = (jnp.arange(d + 1, dtype=jnp.uint32)
                           * jnp.uint32(band_tiles)) << 16
        bounds = jnp.searchsorted(skey, band_bound_keys).astype(jnp.int32)
        band_off = bounds[:-1]
        band_cnt = bounds[1:] - bounds[:-1]
        dropped_local = jnp.sum(jnp.maximum(band_cnt - s_cap, 0))

        slot = jnp.arange(d * s_cap, dtype=jnp.int32)
        sb = slot // s_cap
        j = slot % s_cap
        src = jnp.clip(band_off[sb] + j, 0, e_loc - 1)
        s_valid = j < band_cnt[sb]
        sg_src = sg[src]  # gaussian id per send slot
        send_keys = jnp.where(s_valid, skey[src], jnp.uint32(0xFFFFFFFF))
        keys_r = jax.lax.all_to_all(
            send_keys.reshape(d, s_cap), axis, 0, 0).reshape(recv)
        mkey, perm = jax.lax.sort(
            (keys_r, jnp.arange(recv, dtype=jnp.int32)), num_keys=1)
        tile_offsets, valid = _band_tile_ranges(mkey, b, band_tiles)
        shift = (b * rows * settings.tile_h).astype(jnp.float32)

        # ---- differentiable band render as a function of attrs; the
        # backward all_to_all (autodiff transpose) returns every entry
        # cotangent to its gaussian's owner ----
        nr = raster_ops.NUM_ROWS

        # Entry exchange with f16 rows forward (tile-relative centers; the
        # f16 class the reference stores ALL splat attributes in) and an
        # EXACT f32 transpose backward.  Cotangents must not round: Adam is
        # scale-invariant, so entries whose net gradient nearly cancels
        # would turn f16 rounding into full-step sign flips.  (The forward
        # rounding is parity-class: the reference's rasterizer reads f16
        # attributes too.)
        @jax.custom_vjp
        def exchange(rows_in):
            enc = _encode_exchange(rows_in, send_keys, s_valid, ntx,
                                   settings)
            rows_r = jax.lax.all_to_all(
                enc.reshape(d, s_cap, nr), axis, 0, 0).reshape(recv, nr)
            return _decode_exchange(rows_r[perm], mkey, valid, ntx, shift,
                                    settings)

        def exchange_fwd(rows_in):
            return exchange(rows_in), None

        def exchange_bwd(_, g):
            # exact transpose of mask . decode . a2a . encode . mask (the
            # encode/decode adds are constants; the f16 casts linearize to
            # identity): cotangents ride the wire in f32
            g = jnp.where(valid[:, None], g, 0.0)
            back = jnp.zeros((recv, nr), jnp.float32).at[perm].set(
                g, unique_indices=True)
            back = jax.lax.all_to_all(
                back.reshape(d, s_cap, nr), axis, 0, 0).reshape(
                d * s_cap, nr)
            return (jnp.where(s_valid[:, None], back, 0.0),)

        exchange.defvjp(exchange_fwd, exchange_bwd)

        def band_img(a):
            per_g = raster_ops._pack_per_gauss(a)  # (n_loc, NUM_ROWS)
            send_rows = jnp.where(s_valid[:, None], per_g[sg_src], 0.0)
            entry_rows = exchange(send_rows)
            out = raster_ops.rasterize_tiles(
                entry_rows.T, tile_offsets, ntx, rows, settings, False)
            tiles = raster_ops.tiles_to_image(out, ntx, rows, img_w,
                                              band_h, settings)
            return raster_ops.composite_background(tiles, settings)

        band_pred, vjp_raster = jax.vjp(band_img, attrs)

        # ---- band-local loss with a 2-pixel-row halo exchange (the 5x5
        # DSSIM window support) instead of replicating the full frame ----
        perm_up = [(i, (i + 1) % d) for i in range(d)]
        perm_dn = [(i, (i - 1) % d) for i in range(d)]
        halo_above = jax.lax.ppermute(band_pred[-2:], axis, perm_up)
        halo_below = jax.lax.ppermute(band_pred[:2], axis, perm_dn)
        pgrad_band, parts = band_loss_gradient(
            band_pred, halo_above, halo_below, tgt, b * band_h, img_h,
            loss_cfg)
        (d_attrs,) = vjp_raster(pgrad_band)
        (d_params,) = vjp_proj(d_attrs)
        d_params = _apply_grad_parity(d_params, d_attrs, aux, params_l,
                                      parity_sh)
        metrics = metrics_from_sums(jax.lax.psum(parts, axis),
                                    float(img_h * img_w * 3), loss_cfg)

        counts = aux.num_tiles
        if dp_axis:
            # average the view batch: one psum of O(N/B) bytes over the
            # small dp axis; visibility gating ORs across the batch
            d_params = jax.tree.map(
                lambda x: jax.lax.psum(x, dp_axis) / n_views, d_params)
            counts = jax.lax.psum(counts, dp_axis)

        new_params, new_opt = adam_step(params_l, d_params, opt_l, hp,
                                        counts)
        # per-view totals first (sum the band shards), then reduce views
        visible = jax.lax.psum(jnp.sum(aux.visible.astype(jnp.int32)), axis)
        # post-cull pre-drop demand (see Binning.expansion_entries)
        entries = jax.lax.psum(demand, axis)
        dropped = jax.lax.psum(dropped_local, axis)
        # adaptation observations: the largest per-device expansion load and
        # the largest single (device -> band) send this step
        entries_local = jax.lax.pmax(demand, axis)
        send_max = jax.lax.pmax(jnp.max(band_cnt), axis)
        if dp_axis:
            metrics = {k: jax.lax.psum(v, dp_axis) / n_views
                       for k, v in metrics.items()}
            # per-view MAX like dp_train_step (sizes the entry capacity)
            visible = jax.lax.pmax(visible, dp_axis)
            entries = jax.lax.pmax(entries, dp_axis)
            dropped = jax.lax.psum(dropped, dp_axis)
            entries_local = jax.lax.pmax(entries_local, dp_axis)
            send_max = jax.lax.pmax(send_max, dp_axis)
        metrics["visible"] = visible
        metrics["tile_entries"] = entries
        metrics["entries_dropped"] = dropped
        metrics["entries_local_max"] = entries_local
        metrics["send_max"] = send_max
        return scene_l.with_params(new_params), new_opt, metrics

    return step(scene, opt_state, camera, target)


def band_loss_gradient(band_pred, halo_above, halo_below, target, y0,
                       img_h: int, loss_cfg: LossConfig):
    """Pixel-loss cotangent of one horizontal band of the frame, computed
    band-locally: the 5x5 DSSIM window crosses band borders only through
    the two pixel rows above (``halo_above``) and below (``halo_below``).

    ``band_pred``: (band_h, W, 3) composited band starting at global row
    ``y0``; ``target``: the full (img_h, W, 3) frame.  Rows past ``img_h``
    get a zero cotangent.  Returns (cotangent (band_h, W, 3), the band's
    partial sums [sum |d|, sum d^2, sum dssim]) — the same cotangent as
    ``ops.loss.pixel_loss_gradient`` on the full frame, row for row."""
    band_h = band_pred.shape[0]
    ext = jnp.concatenate([halo_above, band_pred, halo_below], axis=0)
    # edge replication + img_h crop exactly like the full-frame oracle:
    # global row of ext slot i is y0-2+i; clamp into [0, img_h) and
    # re-index locally (wrap-around halo rows at the frame borders are
    # clamped away before they are ever read)
    yy = jnp.arange(band_h + 4) + y0 - 2
    loc = jnp.clip(jnp.clip(yy, 0, img_h - 1) - (y0 - 2), 0, band_h + 3)
    pred_ext = ext[loc]
    tgt_ext = target[jnp.clip(yy, 0, img_h - 1)]

    sm_ext = ssim_map(pred_ext, tgt_ext, loss_cfg.c1, loss_cfg.c2)
    diff_ext = pred_ext - tgt_ext
    grad_ext = (loss_cfg.lambda_l1 * jnp.sign(diff_ext)
                + loss_cfg.lambda_l2 * diff_ext
                + loss_cfg.lambda_dssim * (1.0 - sm_ext) * 0.5 * diff_ext)
    own = slice(2, 2 + band_h)
    row_valid = ((jnp.arange(band_h) + y0) < img_h)[:, None, None]
    dv = jnp.where(row_valid, diff_ext[own], 0.0)
    ds_own = jnp.where(row_valid, (1.0 - sm_ext[own]) * 0.5, 0.0)
    parts = jnp.stack([jnp.sum(jnp.abs(dv)), jnp.sum(dv * dv),
                       jnp.sum(ds_own)])
    return jnp.where(row_valid, grad_ext[own], 0.0), parts


def metrics_from_sums(parts, n_el: float, loss_cfg: LossConfig):
    """Frame metrics from summed band partials (see
    :func:`band_loss_gradient`), matching ``ops.loss.loss_metrics``."""
    l1, l2, dssim = parts[0] / n_el, parts[1] / n_el, parts[2] / n_el
    return {
        "l1": l1,
        "l2": l2,
        "dssim": dssim,
        "loss": (loss_cfg.lambda_l1 * l1 + loss_cfg.lambda_l2 * l2
                 + loss_cfg.lambda_dssim * dssim),
        "psnr": -10.0 * jnp.log10(jnp.maximum(l2, 1e-12)),
    }
