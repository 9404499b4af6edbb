"""Synthesize a genuine on-disk COLMAP dataset for end-to-end CLI training.

Real photos cannot be staged in this environment (no network), so this
script plays the role of the camera + COLMAP: a small numpy *raytracer* —
deliberately independent of the splat renderer — photographs a procedural
3D scene (checkerboard floor, matte/striped spheres, a sky sphere so every
pixel has content like a real photo), and the results are written in the
actual COLMAP binary formats the reference consumes
(README.md:49-51, src/utils/load-camera.ts, load-pointcloud.ts:54-154):

    out/
      images/r_000.png ... (RGB photos)
      sparse/0/cameras.bin   (PINHOLE model 1)
      sparse/0/images.bin    (quaternion w2c + translation per view)
      sparse/0/points3D.bin  (SfM-like surface samples with colors)

The camera model matches the framework's pinhole mapping
(webdgs/ops/projection.py: px = W/2 + f*x_view/z_view,
py = H/2 + f*y_view/z_view with x_view = R(x - C)), i.e. rays for pixel
(u, v) are  d_view = ((u - W/2)/f, (v - H/2)/f, 1).

Usage:
    python scripts/make_synthetic_colmap.py out_dir [--views 48]
        [--width 400] [--height 300] [--points 20000]
"""

from __future__ import annotations

import argparse
import os
import struct

import numpy as np

# ---------------------------------------------------------------------------
# Procedural scene: spheres + checkerboard disc floor + sky sphere.

SPHERES = np.array([
    # cx, cy, cz, radius
    [-1.2, -0.30, 0.00, 0.70],
    [1.10, -0.45, 0.60, 0.55],
    [0.20, -0.60, -1.10, 0.40],
    [0.0, 0.0, 0.0, 20.0],  # sky sphere (hit from inside)
], dtype=np.float64)

FLOOR_Y = -1.0
FLOOR_R = 6.0
LIGHT_DIR = np.array([0.45, 1.0, -0.35])
LIGHT_DIR = LIGHT_DIR / np.linalg.norm(LIGHT_DIR)
AMBIENT = 0.35


def sphere_color(i, p):
    """Per-sphere albedo, some with procedural texture."""
    if i == 0:  # red with latitude stripes
        stripes = 0.5 + 0.5 * np.sin(12.0 * p[:, 1])
        return np.stack([0.85 * np.ones(len(p)), 0.15 + 0.35 * stripes,
                         0.12 * np.ones(len(p))], axis=1)
    if i == 1:  # green
        return np.tile([0.15, 0.75, 0.25], (len(p), 1))
    if i == 2:  # blue with longitude stripes
        ang = np.arctan2(p[:, 2] - SPHERES[2, 2], p[:, 0] - SPHERES[2, 0])
        stripes = 0.5 + 0.5 * np.sin(8.0 * ang)
        return np.stack([0.2 + 0.3 * stripes, 0.25 * np.ones(len(p)),
                         0.8 * np.ones(len(p))], axis=1)
    # sky: vertical gradient + soft bands so the background is trainable
    h = np.clip(p[:, 1] / 20.0, -1, 1)
    band = 0.06 * np.sin(3.0 * np.arctan2(p[:, 2], p[:, 0]))
    return np.stack([0.35 + 0.2 * h + band, 0.45 + 0.25 * h + band,
                     0.65 + 0.3 * h], axis=1)


def floor_color(p):
    check = ((np.floor(p[:, 0] * 1.25) + np.floor(p[:, 2] * 1.25)) % 2)
    c = np.where(check[:, None] > 0.5, np.array([[0.85, 0.82, 0.75]]),
                 np.array([[0.25, 0.22, 0.28]]))
    return c


def intersect_spheres(origin, dirs):
    """Nearest positive hit over all spheres. Returns (t, idx)."""
    n = dirs.shape[0]
    best_t = np.full(n, np.inf)
    best_i = np.full(n, -1, dtype=np.int32)
    for i, (cx, cy, cz, r) in enumerate(SPHERES):
        oc = origin - np.array([cx, cy, cz])
        b = dirs @ oc
        c = oc @ oc - r * r
        disc = b * b - c
        ok = disc > 0
        sq = np.sqrt(np.where(ok, disc, 0.0))
        t1 = -b - sq
        t2 = -b + sq
        t = np.where(t1 > 1e-4, t1, t2)  # inside hits (sky) use far root
        ok &= t > 1e-4
        upd = ok & (t < best_t)
        best_t = np.where(upd, t, best_t)
        best_i = np.where(upd, i, best_i)
    return best_t, best_i


def intersect_floor(origin, dirs):
    denom = dirs[:, 1]
    t = np.where(np.abs(denom) > 1e-9, (FLOOR_Y - origin[1]) / denom, np.inf)
    p = origin[None, :] + t[:, None] * dirs
    ok = (t > 1e-4) & (p[:, 0] ** 2 + p[:, 2] ** 2 < FLOOR_R ** 2)
    return np.where(ok, t, np.inf)


def shade(origin, dirs):
    """Lambertian + ambient with hard shadows from the solid spheres."""
    ts, si = intersect_spheres(origin, dirs)
    tf = intersect_floor(origin, dirs)
    use_floor = tf < ts
    t = np.where(use_floor, tf, ts)
    hit = np.isfinite(t)
    t = np.where(hit, t, 1.0)
    p = origin[None, :] + t[:, None] * dirs

    normal = np.zeros_like(p)
    albedo = np.zeros((len(p), 3))
    emissive = np.zeros(len(p), dtype=bool)
    for i in range(len(SPHERES)):
        m = hit & ~use_floor & (si == i)
        if not m.any():
            continue
        c = SPHERES[i, :3]
        nrm = (p[m] - c) / SPHERES[i, 3]
        if i == len(SPHERES) - 1:  # sky seen from inside; emissive
            nrm = -nrm
            emissive[m] = True
        normal[m] = nrm
        albedo[m] = sphere_color(i, p[m])
    mf = hit & use_floor
    if mf.any():
        normal[mf] = [0.0, 1.0, 0.0]
        albedo[mf] = floor_color(p[mf])

    # shadow ray against the solid spheres only
    sh_origin = p + normal * 1e-4
    in_shadow = np.zeros(len(p), dtype=bool)
    for i in range(len(SPHERES) - 1):
        oc = sh_origin - SPHERES[i, :3]
        b = oc @ LIGHT_DIR
        c = np.einsum("ij,ij->i", oc, oc) - SPHERES[i, 3] ** 2
        disc = b * b - c
        in_shadow |= (disc > 0) & (-b + np.sqrt(np.maximum(disc, 0)) > 1e-4) \
            & (-b - np.sqrt(np.maximum(disc, 0)) > 1e-4)
    ndl = np.clip(normal @ LIGHT_DIR, 0.0, 1.0)
    diff = np.where(in_shadow, 0.0, ndl)
    lit = AMBIENT + (1.0 - AMBIENT) * diff
    col = albedo * np.where(emissive, 1.0, lit)[:, None]
    return np.where(hit[:, None], col, 0.0), p, albedo, hit, emissive


# ---------------------------------------------------------------------------
# Cameras (framework pinhole: d_view = ((u-W/2)/f, (v-H/2)/f, 1))

def look_at_w2c(pos, target, up=(0.0, 1.0, 0.0)):
    fwd = np.asarray(target, float) - np.asarray(pos, float)
    fwd /= np.linalg.norm(fwd)
    up = np.asarray(up, float)
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    camy = np.cross(fwd, right)
    # the framework maps +y_view to increasing image row (projection.py:253),
    # so negate x and y camera axes (a 180-degree roll, still det +1) to get
    # upright photos with world-up at the top of the frame
    return np.stack([-right, -camy, fwd])


def rotmat_to_quat_wxyz(r):
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (r[2, 1] - r[1, 2]) / s,
                         (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s])
    i = int(np.argmax(np.diag(r)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(r[i, i] - r[j, j] - r[k, k] + 1.0, 1e-12)) * 2
    q = np.empty(4)
    q[0] = (r[k, j] - r[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (r[j, i] + r[i, j]) / s
    q[1 + k] = (r[k, i] + r[i, k]) / s
    return q


def render_view(r_w2c, pos, w, h, f):
    u, v = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
    d_view = np.stack([(u.ravel() - 0.5 * w) / f,
                       (v.ravel() - 0.5 * h) / f,
                       np.ones(w * h)], axis=1)
    d_world = d_view @ r_w2c  # = R^T d_view, row-vectors
    d_world /= np.linalg.norm(d_world, axis=1, keepdims=True)
    col, _, _, _, _ = shade(np.asarray(pos, float), d_world)
    return col.reshape(h, w, 3)


# ---------------------------------------------------------------------------
# COLMAP binary writers (formats per src/utils/load-camera.ts:170-288 and
# load-pointcloud.ts:54-154; our loaders in webdgs/io are the readers).

def write_cameras_bin(path, cam_id, w, h, f):
    with open(path, "wb") as fp:
        fp.write(struct.pack("<Q", 1))
        # PINHOLE (model 1): fx fy cx cy
        fp.write(struct.pack("<Ii2Q", cam_id, 1, w, h))
        fp.write(struct.pack("<4d", f, f, w / 2.0, h / 2.0))


def write_images_bin(path, views, cam_id):
    with open(path, "wb") as fp:
        fp.write(struct.pack("<Q", len(views)))
        for i, (r, pos, name) in enumerate(views):
            q = rotmat_to_quat_wxyz(r)
            t = -r @ np.asarray(pos, float)
            fp.write(struct.pack("<I", i + 1))
            fp.write(struct.pack("<7d", *q, *t))
            fp.write(struct.pack("<I", cam_id))
            fp.write(name.encode() + b"\x00")
            fp.write(struct.pack("<Q", 0))  # empty points2D track block


def write_points3d_bin(path, xyz, rgb):
    with open(path, "wb") as fp:
        fp.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            fp.write(struct.pack("<Q", i + 1))
            fp.write(struct.pack("<3d", *xyz[i]))
            fp.write(struct.pack("<3B", *np.clip(rgb[i] * 255.0 + 0.5,
                                                 0, 255).astype(np.uint8)))
            fp.write(struct.pack("<d", 0.5))   # reprojection error
            fp.write(struct.pack("<Q", 0))     # empty track


def sample_sfm_points(views, w, h, f, n_points, rng):
    """SfM-like sparse points: random image samples back-projected to their
    surface hit, with albedo color and slight position noise."""
    per = max(1, n_points // len(views))
    pts, cols = [], []
    for r, pos, _ in views:
        u = rng.uniform(0, w, per)
        v = rng.uniform(0, h, per)
        d_view = np.stack([(u - 0.5 * w) / f, (v - 0.5 * h) / f,
                           np.ones(per)], axis=1)
        d_world = d_view @ r
        d_world /= np.linalg.norm(d_world, axis=1, keepdims=True)
        _, p, albedo, hit, emissive = shade(np.asarray(pos, float), d_world)
        keep = hit & ~emissive  # SfM rarely reconstructs the sky
        pts.append(p[keep])
        cols.append(albedo[keep])
    xyz = np.concatenate(pts)[:n_points]
    rgb = np.concatenate(cols)[:n_points]
    xyz = xyz + rng.normal(0, 0.01, xyz.shape)  # SfM noise
    return xyz, rgb


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--views", type=int, default=48)
    ap.add_argument("--width", type=int, default=400)
    ap.add_argument("--height", type=int, default=300)
    ap.add_argument("--points", type=int, default=20000)
    ap.add_argument("--fov-y-deg", type=float, default=50.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    from PIL import Image

    if args.views < 1 or args.width < 1 or args.height < 1:
        ap.error("--views/--width/--height must be positive")
    rng = np.random.default_rng(args.seed)
    w, h = args.width, args.height
    f = 0.5 * h / np.tan(np.radians(args.fov_y_deg) / 2)
    target = np.array([0.0, -0.3, 0.0])

    views = []
    for i in range(args.views):
        az = 2 * np.pi * i / args.views + rng.normal(0, 0.03)
        el = np.radians(12.0 if i % 2 == 0 else 32.0) + rng.normal(0, 0.02)
        rad = 4.5 + rng.normal(0, 0.1)
        pos = target + rad * np.array([np.cos(el) * np.sin(az), np.sin(el),
                                       np.cos(el) * np.cos(az)])
        views.append((look_at_w2c(pos, target), pos, f"r_{i:03d}.png"))

    img_dir = os.path.join(args.out, "images")
    sparse = os.path.join(args.out, "sparse", "0")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(sparse, exist_ok=True)

    for i, (r, pos, name) in enumerate(views):
        img = render_view(r, pos, w, h, f)
        arr = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(img_dir, name))
        if i == 0:
            print(f"rendered {name} ({w}x{h})")
    print(f"rendered {len(views)} views")

    cam_id = 1
    write_cameras_bin(os.path.join(sparse, "cameras.bin"), cam_id, w, h, f)
    write_images_bin(os.path.join(sparse, "images.bin"), views, cam_id)
    xyz, rgb = sample_sfm_points(views, w, h, f, args.points, rng)
    write_points3d_bin(os.path.join(sparse, "points3D.bin"), xyz, rgb)
    print(f"wrote sparse/0/{{cameras,images,points3D}}.bin "
          f"({len(xyz)} points)")


if __name__ == "__main__":
    main()
