"""Interactive browser viewer served from the GPU host.

The reference IS a browser app (canvas + WASD/pointer controls,
src/main.ts); here the render loop runs on the GPU and a minimal zero-
dependency HTTP server streams JPEG frames to a canvas page with the same
controls (WASD/Space/Ctrl move, Q/E roll, drag to look, wheel to dolly —
handled by render/camera_control.py with the reference's constants).

    python -m webdgs serve scene.ply --port 8000

Live training (the reference's signature UX — watching the scene converge
while flying around it, src/main.ts:537-608 interleaves one trainer.step()
per rAF frame): pass a Trainer and the scene shown in the browser is the
one being optimized, with the training widget (iteration, iters/s, point
count, next densify — main.ts:130-167) in the HUD and a pause/resume
toggle (T key, like the reference's start/stop button).

    python -m webdgs serve --train --points ... --cameras ... --images ...

Instead of interleaving in one loop, training runs in its own thread — JAX
dispatch is thread-safe and the device serializes the actual work, so
frames and train steps share the card exactly like the reference's single
WebGPU queue shares the GPU.
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

PAGE = """<!doctype html>
<html><head><title>webdgs viewer</title><style>
body { margin:0; background:#111; color:#ccc; font-family:monospace; }
#hud { position:fixed; top:8px; left:8px; }
canvas { display:block; margin:0 auto; }
</style></head><body>
<div id="hud">webdgs &mdash; WASD/Space/Ctrl move &middot; drag look
&middot; Q/E roll &middot; wheel dolly &middot; P point mode &middot; L loss view
&middot; [/] splat scale &middot; C config &middot; drop a .ply / points3D.bin
to load it (or a whole COLMAP dataset &mdash; points + cameras.bin +
images.bin + images &mdash; to train)
<span id="stats"></span></div>
<div id="cfg" style="display:none; position:fixed; top:28px; left:8px;
background:#1b1b1bee; padding:8px 12px; border:1px solid #333;"></div>
<canvas id="c"></canvas>
<script>
const c = document.getElementById('c'), ctx = c.getContext('2d');
// live hyperparameter sliders, the reference's training controls
// (index.html:105-179 ranges; main.ts:301-372 wiring) — each input posts a
// deep-partial config update applied to the NEXT training step
// [path, label, lo, hi, init, isInt] — ranges mirror the reference's
// control panel (index.html:105-212) plus the densify knobs it keeps
// config-only (trainer.ts:147-164)
const SLIDERS = [
  ['max_iterations',  'iterations',  1000, 50000, 10000, 1],
  ['adam.lr_pos',     'lr position', 0, 0.001,  0.00016, 0],
  ['adam.lr_rot',     'lr rotation', 0, 0.01,   0.001, 0],
  ['adam.lr_scale',   'lr scale',    0, 0.05,   0.005, 0],
  ['adam.lr_opacity', 'lr opacity',  0, 0.2,    0.05, 0],
  ['adam.lr_color',   'lr color',    0, 0.02,   0.0025, 0],
  ['loss.lambda_l1',  'lambda L1',   0, 1,      0.8, 0],
  ['loss.lambda_l2',  'lambda L2',   0, 1,      0.0, 0],
  ['loss.lambda_dssim','lambda DSSIM',0, 1,     0.2, 0],
  ['densify.schedule.warmup_iterations', 'densify warmup', 0, 5000, 500, 1],
  ['densify.schedule.interval', 'densify interval', 10, 500, 100, 1],
  ['densify.schedule.stop_iterations', 'densify stop', 1000, 50000, 15000, 1],
  ['densify.metric_threshold',  'metric threshold', 0, 1, 0.5, 0],
  ['densify.prune_opacity',     'prune opacity', 0, 0.2, 0.01, 0],
];
const cfgDiv = document.getElementById('cfg');
const lossWarn = document.createElement('div');
lossWarn.style.cssText = 'color:#e0a030;max-width:360px;display:none';
cfgDiv.appendChild(lossWarn);
const sliderRefs = [];  // synced to the live trainer config on first /stats
// the reference warns when the loss weights drift off sum 1
// (main.ts:301-321); same check, live on every lambda change
function checkLossSum() {
  let sum = 0;
  for (const [path, inp] of sliderRefs)
    if (path.startsWith('loss.lambda')) sum += +inp.value;
  lossWarn.textContent = Math.abs(sum - 1) > 0.01
    ? `loss weights sum to ${sum.toFixed(2)} (expected 1.0): ` +
      'the effective learning rate scales with the sum' : '';
  lossWarn.style.display = lossWarn.textContent ? 'block' : 'none';
}
for (const [path, label, lo, hi, init, isInt] of SLIDERS) {
  const row = document.createElement('div');
  row.innerHTML = `<label style="display:inline-block;width:130px">${label}</label>
    <input type="range" min="${lo}" max="${hi}" step="${isInt ? Math.max(1, Math.round((hi-lo)/200)) : (hi-lo)/200}" value="${init}"
     style="width:160px;vertical-align:middle">
    <span style="display:inline-block;width:70px">${init}</span>`;
  const inp = row.querySelector('input'), val = row.querySelector('span');
  // debounce: each config post rebuilds the jitted step (a full retrace),
  // so a drag must coalesce to ONE post, not one per input tick
  let cfgTimer = null;
  inp.oninput = () => {
    val.textContent = fmtVal(inp.value, isInt);
    checkLossSum();
    clearTimeout(cfgTimer);
    cfgTimer = setTimeout(() => {
      const cfg = {}; let o = cfg;
      const parts = path.split('.');
      for (let i = 0; i < parts.length - 1; i++) o = o[parts[i]] = {};
      o[parts[parts.length-1]] = isInt ? Math.round(+inp.value) : +inp.value;
      post({config: cfg});
    }, 250);
  };
  sliderRefs.push([path, inp, val, isInt]);
  cfgDiv.appendChild(row);
}
// the init constants above are only placeholders: the running config may
// carry CLI/--config overrides, so sliders snap to the live values (the
// reference's sliders and its configs share one source, main.ts:234-372)
// camera presets, the reference's camera-choice select (index.html:236):
// jump the fly-cam to any dataset camera
const camRow = document.createElement('div');
camRow.innerHTML = `<label style="display:inline-block;width:130px">camera</label>
  <select style="width:160px"><option value="">free</option></select>`;
const camSel = camRow.querySelector('select');
camSel.onchange = () => {
  if (camSel.value !== '') post({camera_preset: +camSel.value});
};
cfgDiv.appendChild(camRow);
function syncCameras(s) {
  const n = s.trainer ? (s.trainer.n_cameras || 0) : 0;
  while (camSel.options.length > 1 + n) camSel.remove(camSel.options.length - 1);
  for (let i = camSel.options.length - 1; i < n; i++)
    camSel.add(new Option(`cam ${i}`, i));
}
function syncSliders(s) {
  syncCameras(s);
  if (!s.trainer || !s.trainer.config) return;
  for (const [path, inp, val, isInt] of sliderRefs) {
    if (path in s.trainer.config) {
      const v = s.trainer.config[path];
      // widen the range first: a CLI/--config override outside the
      // reference's slider envelope must DISPLAY truthfully, not clamp
      // (and a later drag must not silently rewrite it to the clamp)
      if (v < +inp.min) inp.min = v;
      if (v > +inp.max) inp.max = v;
      inp.value = v;
      val.textContent = fmtVal(v, isInt);
    }
  }
  checkLossSum();
}
function fmtVal(v, isInt) {
  return isInt ? String(Math.round(+v)) : (+v).toPrecision(3);
}
let keys = {}, drag = null, wheel = 0;
onkeydown = e => { keys[e.code] = true; if(e.code=='KeyP') post({toggle_mode:1});
                   if(e.code=='KeyT') post({toggle_train:1});
                   if(e.code=='KeyC') cfgDiv.style.display =
                       cfgDiv.style.display=='none' ? 'block' : 'none';
                   if(e.code=='KeyL') showLoss = !showLoss;
                   if(e.code=='BracketLeft') post({gaussian_scale_delta:-0.05});
                   if(e.code=='BracketRight') post({gaussian_scale_delta:0.05});
                   if(e.code=='Comma') post({point_size_delta:-1});
                   if(e.code=='Period') post({point_size_delta:1}); };
onkeyup = e => keys[e.code] = false;
c.onpointerdown = e => { drag = [e.pageX, e.pageY]; c.setPointerCapture(e.pointerId); };
c.onpointerup = () => drag = null;
c.onpointermove = e => {
  if (drag) { post({drag:[e.pageX-drag[0], e.pageY-drag[1]]}); drag=[e.pageX,e.pageY]; }
};
c.onwheel = e => { e.preventDefault(); post({wheel: e.deltaY}); };
function post(o) { fetch('/control', {method:'POST', body:JSON.stringify(o)}); }
// in-browser scene loading, the reference's file-input/drag-drop entry
// point (main.ts:234-503, load.ts:6): drop a .ply or points3D.bin on the
// page and the live scene swaps without a process restart
const upMsg = document.createElement('span');
document.getElementById('hud').appendChild(upMsg);
async function upload(f) {
  const r = await fetch('/upload?name=' + encodeURIComponent(f.name),
                        {method: 'POST', body: f});
  const j = await r.json();
  if (!r.ok) throw new Error(j.error);
  return j;
}
// multi-file batches (a whole COLMAP dataset at once): images stream
// first, metadata last, then /upload_done assembles the dataset ONCE and
// (in view-only sessions) starts training — the reference's three file
// pickers (main.ts:405-458) collapsed into one drop target
async function uploadAll(files) {
  const meta = [], rest = [];
  for (const f of files)
    (/\\.(bin|json|ply)$/i.test(f.name) ? meta : rest).push(f);
  const ordered = rest.concat(meta);
  let last = null;
  try {
    for (let i = 0; i < ordered.length; i++) {
      upMsg.textContent = ` | loading ${ordered[i].name} (${i+1}/${ordered.length})...`;
      last = await upload(ordered[i]);
    }
    const d = await (await fetch('/upload_done', {method:'POST'})).json();
    upMsg.textContent = d.dataset && d.dataset !== 'no files staged'
      ? ` | ${d.dataset}`
      : (last && last.points != null ? ` | loaded ${last.points} pts` : ' | loaded');
  } catch (e) { upMsg.textContent = ` | upload failed: ${e.message || e}`; }
  setTimeout(() => upMsg.textContent = '', 8000);
}
document.body.ondragover = e => e.preventDefault();
document.body.ondrop = e => {
  e.preventDefault();
  if (e.dataTransfer.files.length) uploadAll([...e.dataTransfer.files]);
};
// click-to-browse fallback in the config panel (the reference's
// <input type=file>, index.html)
const fileRow = document.createElement('div');
fileRow.innerHTML = `<label style="display:inline-block;width:130px">scene/dataset</label>
  <input type="file" multiple accept=".ply,.bin,.json,.jpg,.jpeg,.png" style="width:220px">`;
fileRow.querySelector('input').onchange = e => {
  if (e.target.files.length) uploadAll([...e.target.files]);
};
cfgDiv.appendChild(fileRow);
setInterval(() => {
  const m = {move:[!!keys.KeyW,!!keys.KeyS,!!keys.KeyA,!!keys.KeyD,
                   !!keys.Space,!!keys.ControlLeft||!!keys.ControlRight],
             roll:[!!keys.KeyQ,!!keys.KeyE], dt:0.05};
  if (m.move.some(x=>x) || m.roll.some(x=>x)) post(m);
}, 50);
let showLoss = false;
function sendResize() { post({resize:[innerWidth, innerHeight - 24]}); }
onresize = sendResize;
async function loop() {
  sendResize();
  const s0 = await (await fetch('/stats')).json();
  c.width = s0.width; c.height = s0.height;
  syncSliders(s0);
  while (true) {
    const r = await fetch((showLoss ? '/loss.jpg?' : '/frame.jpg?') + Date.now());
    const b = await r.blob();
    const img = await createImageBitmap(b);
    // motion frames arrive at reduced resolution; stretch to the canvas
    ctx.drawImage(img, 0, 0, c.width, c.height);
  }
}
loop();
setInterval(async () => {
  const s = await (await fetch('/stats')).json();
  if (c.width != s.width || c.height != s.height) {
    c.width = s.width; c.height = s.height;
  }
  let t = ` | ${s.points} pts | ${s.fps.toFixed(1)} fps | ${s.render_mode}`;
  if (s.trainer) {
    const tr = s.trainer;
    t += ` | iter ${tr.iteration}/${tr.max_iterations}`
       + ` | ${tr.iters_per_sec.toFixed(1)} it/s`
       + (tr.psnr != null ? ` | psnr ${tr.psnr.toFixed(2)}` : '')
       + (tr.holdout_psnr != null ? ` | holdout ${tr.holdout_psnr.toFixed(2)}` : '')
       + (tr.next_densify != null ? ` | densify@${tr.next_densify}` : '')
       + (tr.error ? ` | ERROR: ${tr.error}`
          : (tr.training ? ' | TRAINING (T pauses)' : ' | paused (T resumes)'));
  }
  document.getElementById('stats').textContent = t;
}, 1000);
</script></body></html>
"""


def _flatten_config(cfg) -> dict:
    """TrainerConfig -> {'adam.lr_pos': 0.00016, ...}: every scalar leaf of
    the nested frozen dataclasses keyed by its dotted path (the same paths
    the page's slider table and /control deep partials use)."""
    import dataclasses

    flat: dict = {}

    def walk(obj, prefix):
        for f in dataclasses.fields(obj):
            val = getattr(obj, f.name)
            path = f"{prefix}{f.name}"
            if dataclasses.is_dataclass(val):
                walk(val, path + ".")
            elif isinstance(val, (int, float, bool)):
                flat[path] = val

    walk(cfg, "")
    return flat


class ViewerServer:
    # render at reduced resolution while the camera is moving (input within
    # this window); the page stretches to the canvas, so motion stays
    # fluid and stills are sharp.  After motion stops the resolution
    # refines PROGRESSIVELY — one octave per frame — so a large viewport
    # settles through a quick intermediate frame instead of stalling on
    # one slow full-res render.
    MOTION_WINDOW_S = 0.4
    MOTION_DOWNSCALE = 2

    # evaluate the holdout split (when one exists) this often during live
    # training; a handful of views at the training resolution costs a few
    # frames' worth of device time
    HOLDOUT_EVAL_EVERY = 500
    HOLDOUT_EVAL_VIEWS = 4

    def __init__(self, viewer, quality: int = 85, trainer=None,
                 start_training: bool = True,
                 motion_downscale: int | None = None,
                 holdout: tuple[list, list] | None = None):
        self.viewer = viewer
        self.quality = quality
        self.lock = threading.Lock()
        # guards the small shared flags below (training/_loss_view/...);
        # separate from self.lock, which serializes device-touching work —
        # handle_control holds self.lock while toggling these
        self._state_lock = threading.Lock()
        self.fps = 0.0  # EMA like the reference HUD (main.ts:550-561)
        self._last_input = 0.0
        self._down_level = 1  # current progressive-refine octave
        if motion_downscale is not None:
            self.MOTION_DOWNSCALE = motion_downscale
        self.trainer = trainer
        self.training = bool(trainer) and start_training
        self.train_error: str | None = None
        self._loss_view: tuple[int, float] = (0, 0.0)  # (index, chosen_at)
        self.holdout = holdout if holdout and holdout[0] else None
        self._holdout_groups: dict | None = None  # grouped once, first eval
        self.holdout_psnr: float | None = None
        self._shutdown = threading.Event()
        # serializes trainer-STATE mutation (scene/opt swaps) against an
        # in-flight step: without it an upload's resume_from would be
        # overwritten by the concurrent step's `self.scene = ...` result
        self._step_lock = threading.Lock()
        # browser-uploaded dataset pieces (COLMAP camera metadata + ground-
        # truth images) staged until a complete training set exists — the
        # reference's camera-input/images-input file pickers
        # (src/main.ts:405-458 -> trainer.setDataset)
        self._dataset_stage: dict = {"extr": None, "intr": None,
                                     "json": None, "imgs": {}}
        self._assemble_lock = threading.Lock()
        self._train_thread: threading.Thread | None = None
        if trainer is not None:
            self._start_train_thread()

    def _start_train_thread(self) -> None:
        self._train_thread = threading.Thread(
            target=self._train_loop, daemon=True, name="webdgs-train")
        self._train_thread.start()

    # -- live training (reference main.ts:595-600: one step per frame) ----
    def _train_loop(self) -> None:
        tr = self.trainer
        while not self._shutdown.is_set():
            if tr.iteration >= tr.config.max_iterations:
                with self._state_lock:
                    self.training = False
            if not self.training:
                self._shutdown.wait(0.05)
                continue
            try:
                with self._step_lock:
                    tr.step()
                if (self.holdout is not None
                        and tr.iteration % self.HOLDOUT_EVAL_EVERY == 0):
                    if self._holdout_groups is None:
                        # group/stack/upload the holdout views ONCE; every
                        # later eval is a pure device call
                        from webdgs.train.trainer import _group_views
                        cams, imgs = self.holdout
                        self._holdout_groups = _group_views(
                            cams[:self.HOLDOUT_EVAL_VIEWS],
                            imgs[:self.HOLDOUT_EVAL_VIEWS])
                    r = tr.evaluate(groups=self._holdout_groups)
                    self.holdout_psnr = r["psnr"]
            except Exception as e:  # surface the failure in the HUD
                import traceback
                traceback.print_exc()
                with self._state_lock:
                    self.train_error = f"{type(e).__name__}: {e}"
                    self.training = False
                continue
            # the scene pytree is immutable; publishing the new one to the
            # frame renderer is a single atomic attribute store (the
            # analogue of the reference's pointcloud swap, main.ts:508)
            self.viewer.set_point_cloud(tr.scene)

    def handle_upload(self, name: str, data: bytes) -> dict:
        """Adopt an uploaded file — the reference's in-browser file-input/
        drag-drop entry points (src/main.ts:234-503).  Three input classes,
        matching the reference's three pickers:

          * scene files (binary PLY / COLMAP points3D.bin, dispatched on
            magic bytes like src/utils/load.ts:6): swap the live scene;
            with a trainer attached, training restarts from the new points
            (trainer.setPointCloud semantics: fresh optimizer, iteration 0);
          * camera metadata (cameras.bin / images.bin / cameras .json,
            dispatched on file NAME like load-camera.ts:25-47): staged;
          * ground-truth images (.jpg/.png): staged by filename.

        Once the staged set holds camera extrinsics and at least one image,
        the dataset is assembled (name-paired like the CLI) and handed to
        the trainer via ``set_dataset`` — or, in view-only serve mode, a
        fresh Trainer is created from the current scene and training starts
        entirely from the browser (the reference's main.ts:419,449 flow)."""
        low = name.lower()
        if low.endswith("cameras.bin"):
            from webdgs.io.colmap import load_cameras_bin
            with self._state_lock:
                self._dataset_stage["intr"] = load_cameras_bin(data)
                n = len(self._dataset_stage["intr"])
            return {"name": name, "staged": "camera intrinsics",
                    "count": n}
        if low.endswith("images.bin"):
            from webdgs.io.colmap import load_images_bin
            with self._state_lock:
                self._dataset_stage["extr"] = load_images_bin(data)
                n = len(self._dataset_stage["extr"])
            return {"name": name, "staged": "camera extrinsics",
                    "count": n}
        if low.endswith(".json"):
            from webdgs.io.colmap import load_cameras_json
            with self._state_lock:
                self._dataset_stage["json"] = load_cameras_json(data)
                n = len(self._dataset_stage["json"])
            return {"name": name, "staged": "cameras (json)",
                    "count": n}
        if low.endswith((".jpg", ".jpeg", ".png")):
            from PIL import Image
            arr = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"),
                             dtype=np.float32) / 255.0
            import os
            base = os.path.basename(name)
            with self._state_lock:
                self._dataset_stage["imgs"][base] = {
                    "name": base, "image": arr,
                    "width": arr.shape[1], "height": arr.shape[0]}
                n = len(self._dataset_stage["imgs"])
            return {"name": name, "staged": "image", "count": n}
        from webdgs.io.ply import load_point_cloud
        scene = load_point_cloud(data)
        n = int(scene.num_alive())
        if self.trainer is not None:
            with self._state_lock:
                was_training = self.training
                self.training = False
            # wait out any in-flight step, then swap under the step lock so
            # a racing step cannot publish the OLD scene over the new one
            with self._step_lock:
                self.trainer.resume_from(scene, None, 0)
                scene = self.trainer.scene  # the capacity-padded copy
            with self._state_lock:
                self.train_error = None
                self.training = was_training
        with self.lock:
            self.viewer.set_point_cloud(scene)
            self.viewer.frame_scene()
        return {"name": name, "points": n}

    def _assemble_dataset(self) -> str:
        """Try to build (cameras, images) from the staged uploads and hand
        them to the trainer — creating one if this is a view-only session
        (the reference requires a trainer to pre-exist; here 'drop COLMAP
        files on the viewer' IS the training entry point).  Returns a
        human-readable status for the upload response."""
        # serialize whole assemblies: two concurrent /upload_done posts
        # must not each bootstrap a Trainer (ThreadingHTTPServer runs
        # handlers concurrently)
        with self._assemble_lock:
            return self._assemble_dataset_locked()

    def _assemble_dataset_locked(self) -> str:
        with self._state_lock:
            st = self._dataset_stage
            extr, intr, js = st["extr"], st["intr"], st["json"]
            imgs = dict(st["imgs"])
        if extr is None and intr is None and js is None and not imgs:
            return "no files staged"
        if js is not None:
            cams = js
        elif extr is not None:
            if intr is not None:
                from webdgs.io.colmap import merge_extrinsics_intrinsics
                cams = merge_extrinsics_intrinsics(extr, intr)
            else:
                cams = extr
        else:
            return "waiting for camera extrinsics (images.bin or .json)"
        if not imgs:
            return "waiting for ground-truth images"
        from webdgs.io.images import numeric_key
        # pair by exact filename when the metadata carries names (COLMAP
        # images.bin always does); otherwise numeric-sorted index pairing,
        # the CLI's (and reference's trainer.ts:573-575) convention
        named = [(c, imgs[c.img_name]) for c in cams
                 if c.img_name and c.img_name in imgs]
        if named:
            named.sort(key=lambda p: numeric_key(p[0].img_name))
            cameras = [c for c, _ in named]
            images = [m for _, m in named]
        else:
            cs = sorted(cams, key=lambda c: numeric_key(c.img_name or
                                                        str(c.id)))
            ms = sorted(imgs.values(), key=lambda m: numeric_key(m["name"]))
            n = min(len(cs), len(ms))
            cameras, images = cs[:n], ms[:n]
        if not cameras:
            return "no camera/image pairs"
        if self.trainer is not None:
            with self._step_lock:
                self.trainer.set_dataset(cameras, images)
            return f"dataset set: {len(cameras)} views"
        # view-only session: bootstrap a Trainer on the live scene with the
        # default config (sliders/config posts mutate it from the browser)
        from webdgs.train.config import TrainerConfig
        from webdgs.train.trainer import Trainer
        trainer = Trainer(self.viewer.scene, cameras, images,
                          TrainerConfig(), self.viewer.settings)
        trainer.dataset_cameras = cameras
        with self._state_lock:
            self.trainer = trainer
            self.train_error = None
            self.training = True
        self._start_train_thread()
        return f"training started: {len(cameras)} views"

    def toggle_training(self) -> bool:
        if self.trainer is None:
            return False
        with self._state_lock:
            if self.trainer.iteration < self.trainer.config.max_iterations:
                self.training = not self.training
            return self.training

    def shutdown(self) -> None:
        self._shutdown.set()
        if self._train_thread is not None:
            self._train_thread.join(timeout=30)

    CONTROL_KEYS = frozenset((
        "move", "roll", "drag", "wheel", "dt", "toggle_mode", "toggle_train",
        "config", "gaussian_scale_delta", "point_size_delta", "resize",
        "camera_preset"))

    def handle_control(self, msg: dict) -> list[str]:
        """Apply a control message; returns any unrecognized keys so a
        malformed client payload (e.g. a config partial missing its
        ``config`` wrapper) fails loudly instead of silently no-oping."""
        ctl = self.viewer.control
        if any(k in msg for k in ("move", "roll", "drag", "wheel")):
            self._last_input = time.monotonic()
        with self.lock:
            if "move" in msg:
                f, b, l, r, u, d = msg["move"]
                ctl.move(msg.get("dt", 0.05), forward=f, backward=b,
                         left=l, right=r, up=u, down=d)
            if "roll" in msg:
                ql, qe = msg["roll"]
                ctl.roll(msg.get("dt", 0.05), left=ql, right=qe)
            if "drag" in msg:
                dx, dy = msg["drag"]
                ctl.drag(dx, dy)
            if "wheel" in msg:
                ctl.wheel(float(msg["wheel"]))
            if "toggle_mode" in msg:
                self.viewer.set_render_mode(
                    "pointcloud" if self.viewer.render_mode == "gaussian"
                    else "gaussian")
            if "toggle_train" in msg:
                self.toggle_training()
            if "config" in msg and self.trainer is not None:
                # live hyperparameter mutation, the reference's slider
                # setters (src/trainer.ts:248-283 deep partials); applies
                # from the next training step (rebuilds the jit closures)
                try:
                    self.trainer.set_config(msg["config"])
                except (ValueError, TypeError) as e:
                    with self._state_lock:
                        self.train_error = f"config: {e}"
            if "camera_preset" in msg:
                # jump the fly-cam to a dataset camera, the reference's
                # camera-choice select (index.html:236): position/rotation
                # from the CameraData record, fovY re-derived from (fy,
                # height) exactly like Camera.set_preset
                # (camera.ts:196-205)
                cams = getattr(self.trainer, "dataset_cameras", None)
                if cams:
                    import math
                    c = cams[int(msg["camera_preset"]) % len(cams)]
                    if c.position is not None:
                        self.viewer.control.position = np.asarray(
                            c.position, np.float32)
                    if c.rotation is not None:
                        self.viewer.control.rotation = np.asarray(
                            c.rotation, np.float32)
                    if c.fy and c.height:
                        self.viewer.fov_y = 2.0 * math.atan(
                            c.height / (2.0 * c.fy))
            if "gaussian_scale_delta" in msg:
                cur = self.viewer.gaussian_scaling
                self.viewer.set_gaussian_scaling(
                    cur + float(msg["gaussian_scale_delta"]))
            if "point_size_delta" in msg:
                self.viewer.set_point_size(max(
                    1.0, self.viewer.point_size_px
                    + float(msg["point_size_delta"])))
            if "resize" in msg:
                # the reference viewer tracks its canvas via a
                # ResizeObserver (viewer.ts:33-43); quantize to multiples
                # of 64 to bound the number of compiled viewports
                w, h = msg["resize"]
                w = int(np.clip((int(w) // 64) * 64, 64, 3840))
                h = int(np.clip((int(h) // 64) * 64, 64, 2160))
                if (w, h) != (self.viewer.width, self.viewer.height):
                    self.viewer.width, self.viewer.height = w, h
        return [k for k in msg if k not in self.CONTROL_KEYS]

    def stats(self) -> dict:
        """HUD stats, the analogue of the reference's live widget
        (main.ts:130-167): fps, point count, render mode, and — when a
        trainer is attached — iteration, iters/s, psnr, next densify."""
        out = {
            "fps": self.fps,
            "points": int(self.viewer.scene.num_alive()),
            "render_mode": self.viewer.render_mode,
            "width": self.viewer.width,
            "height": self.viewer.height,
        }
        if self.trainer is not None:
            tr = self.trainer
            m = tr.last_metrics
            psnr = m.get("psnr") if isinstance(m, dict) else None
            out["trainer"] = {
                "iteration": tr.iteration,
                "max_iterations": tr.config.max_iterations,
                "iters_per_sec": tr.iters_per_sec,
                "points": tr.num_points,
                "psnr": None if psnr is None else float(psnr),
                "loss": (None if not isinstance(m, dict) or "loss" not in m
                         else float(m["loss"])),
                "next_densify": tr.next_densify_iteration(),
                "training": self.training,
                "error": self.train_error,
                "holdout_psnr": self.holdout_psnr,
                "n_cameras": len(getattr(tr, "dataset_cameras", None) or ()),
                # live config leaves by dotted path, so the page's sliders
                # show the RUNNING values (CLI/--config overrides included),
                # not their hardcoded init constants
                "config": _flatten_config(tr.config),
            }
        return out

    def frame_jpeg(self) -> bytes:
        from PIL import Image
        moving = (time.monotonic() - self._last_input) < self.MOTION_WINDOW_S
        t0 = time.perf_counter()
        with self.lock:
            # progressive refine: motion frames render at MOTION_DOWNSCALE;
            # once input stops, each successive frame halves the downscale
            # until full res (with the default of 2 that is one step; with
            # --motion-downscale 4 a still settles 4 -> 2 -> 1)
            down = (self.MOTION_DOWNSCALE if moving
                    else max(1, self._down_level // 2))
            self._down_level = down
            img = self.viewer.render(downscale=down)
        dt = time.perf_counter() - t0
        inst = 1.0 / dt if dt > 0 else 0.0
        self.fps = inst if self.fps == 0 else 0.9 * self.fps + 0.1 * inst
        arr = (np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=self.quality)
        return buf.getvalue()

    LOSS_VIEW_HOLD_S = 2.0

    def loss_jpeg(self) -> bytes:
        """Per-pixel |loss gradient| of a dataset view — the reference's
        show-loss debug toggle (main.ts:362-367, trainer.ts:695-768).
        Requires an attached trainer; falls back to the normal frame in
        view-only mode.  The sampled view is held for a couple of seconds
        (the page polls this endpoint at frame rate — a fresh random view
        per fetch would flicker and waste device time)."""
        if self.trainer is None:
            return self.frame_jpeg()
        from PIL import Image
        import random as _random
        now = time.monotonic()
        with self._state_lock:
            idx, chosen = self._loss_view
            if now - chosen > self.LOSS_VIEW_HOLD_S:
                flat_count = sum(g["count"]
                                 for g in self.trainer.groups.values())
                idx = _random.randrange(flat_count)
                self._loss_view = (idx, now)
        img = np.asarray(self.trainer.visualize_loss(idx))
        # abs-value vis like the reference's fs_abs blit (blit.wgsl:27-37)
        arr = (np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=self.quality)
        return buf.getvalue()

    def serve(self, port: int = 8000, host: str = "127.0.0.1") -> None:
        server = make_http_server(self, host, port)
        mode = " (live training)" if self.trainer is not None else ""
        print(f"viewer at http://{host}:{port}/{mode}")
        try:
            server.serve_forever()
        finally:
            self.shutdown()


def make_http_server(vs: ViewerServer, host: str, port: int):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/frame.jpg"):
                self._send(200, vs.frame_jpeg(), "image/jpeg")
            elif self.path.startswith("/loss.jpg"):
                self._send(200, vs.loss_jpeg(), "image/jpeg")
            elif self.path.startswith("/stats"):
                self._send(200, json.dumps(vs.stats()).encode(),
                           "application/json")
            elif self.path == "/" or self.path.startswith("/index"):
                self._send(200, PAGE.encode(), "text/html")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path == "/control":
                length = int(self.headers.get("Content-Length", 0))
                msg = json.loads(self.rfile.read(length) or b"{}")
                unknown = vs.handle_control(msg)
                body = (json.dumps({"unknown_keys": unknown}).encode()
                        if unknown else b"{}")
                self._send(200, body, "application/json")
            elif self.path.startswith("/upload_done"):
                try:
                    status = vs._assemble_dataset()
                    self._send(200, json.dumps(
                        {"dataset": status}).encode(), "application/json")
                except Exception as e:  # bad pairing etc.: report, keep state
                    self._send(400, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode(),
                        "application/json")
            elif self.path.startswith("/upload"):
                from urllib.parse import parse_qs, urlparse
                q = parse_qs(urlparse(self.path).query)
                name = (q.get("name") or ["scene"])[0]
                length = int(self.headers.get("Content-Length", 0))
                data = self.rfile.read(length)
                try:
                    out = vs.handle_upload(name, data)
                    self._send(200, json.dumps(out).encode(),
                               "application/json")
                except Exception as e:  # malformed file: report, keep scene
                    self._send(400, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode(),
                        "application/json")
            else:
                self._send(404, b"not found", "text/plain")

    return ThreadingHTTPServer((host, port), Handler)
