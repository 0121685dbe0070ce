"""Plain reference of the camera path tracer and the probe estimator.

Straightforward PyTorch (or NumPy for the camera matrices): the world
triangles are baked here from the benchmark's own meshes and transforms,
every ray is traced against every triangle (no culls, no reorder), and
each segment shades the Default material of the reference renderer:

* RNG: TEA-hashed seed, 24-bit LCG draws (``LinearCongruenceGenerator``);
* camera: jittered pinhole rays through the inverse projection-view;
* closest hit: Moller-Trumbore, the least t, ties to the lowest triangle
  index; the shading normal is the corner normals' blend, normalized and
  turned toward the ray;
* shade: the flat sky on a miss, emission, a cone sample about the
  reflection (concentration = metallic), throughput times albedo times
  clamp(|N.L| roughness + (1 - roughness) (m + 2) / (m + 1), 0, 1);
* progressive accumulation: history weighted by the frame id, gamma 2.2.

It imports nothing of the program. ``dtype`` sets the precision of every
floating-point step (float32 as the configurations state; the control
runs it in bfloat16); the RNG's integer hash is exact in any case.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_TWO_PI = 6.2831853071795864769
_TMAX = 1e20
_HIT_MAX = 1e19
_BOUNCE_TMIN = 1e-3
_NO_HIT = 999999.0
_DET_EPS = 1e-12
# (rays x triangles) elements of one block of the brute-force trace
_BLOCK = 1 << 23


# ----------------------------------------------------------------- RNG


def lcg_init(v0: torch.Tensor, v1: torch.Tensor) -> torch.Tensor:
    """TEA hash of two uint32 values held in int64 (16 rounds)."""
    v0 = v0.to(torch.int64) & MASK32
    v1 = v1.to(torch.int64) & MASK32
    v0, v1 = torch.broadcast_tensors(v0, v1)
    s0 = 0
    for _ in range(16):
        s0 = (s0 + 0x9E3779B9) & MASK32
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) & MASK32) ^ ((v1 + s0) & MASK32)
                    ^ ((v1 >> 5) + 0xC8013EA4) & MASK32)) & MASK32
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) & MASK32) ^ ((v0 + s0) & MASK32)
                    ^ ((v0 >> 5) + 0x7E95761E) & MASK32)) & MASK32
    return v0


def lcg_next(state: torch.Tensor, dtype):
    """One LCG draw: (new state, uniform in [0, 1) of ``dtype``)."""
    state = (state * 1664525 + 1013904223) & MASK32
    return state, (state & 0x00FFFFFF).to(dtype) * (1.0 / 16777216.0)


# ----------------------------------------------------------------- math


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _normalize(v):
    return v * (1.0 / torch.sqrt(_dot(v, v)))[..., None]


def _cos_sin(phi):
    p = phi.to(torch.float64)
    return torch.cos(p).to(phi.dtype), torch.sin(p).to(phi.dtype)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _tangent_space(n):
    """Orthonormal tangent and binormal about ``n``: helper +X unless
    |n.x| > 0.99, then +Z."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    use_z = torch.abs(nx) > 0.99
    hx = torch.where(use_z, 0.0, 1.0).to(n.dtype)
    hz = torch.where(use_z, 1.0, 0.0).to(n.dtype)
    t = torch.stack([ny * hz, nz * hx - nx * hz, -ny * hx], dim=-1)
    t = t * (1.0 / torch.sqrt(torch.clamp(_dot(t, t), min=1e-20)))[..., None]
    b = _cross(n, t)
    b = b * (1.0 / torch.sqrt(torch.clamp(_dot(b, b), min=1e-20)))[..., None]
    return t, b


def sample_cone(state, axis, alpha, dtype):
    """Direction about ``axis`` with cos(theta) uniform in
    [1 - (1 - alpha)^2, 1]; ``alpha`` None draws cos(theta) uniform in
    [0, 1) (the estimator's hemisphere). Two draws: cos(theta), then phi."""
    state, u_cos = lcg_next(state, dtype)
    state, u_phi = lcg_next(state, dtype)
    if alpha is None:
        cos_t = u_cos
    else:
        om = 1.0 - alpha
        cos_t = 1.0 - u_cos * om * om
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    c, s = _cos_sin(_TWO_PI * u_phi)
    t, b = _tangent_space(axis)
    out = (t * (c * sin_t)[..., None] + b * (s * sin_t)[..., None]) + axis * cos_t[..., None]
    return state, out


# ----------------------------------------------------------------- scene


class Triangles:
    """World triangles on one device: v0, e1, e2 and the three corner
    normals (T, 3) in ``dtype``, the material index (T,), and the material
    table (M, 6): albedo rgb, roughness, metallic, emission."""

    def __init__(self, v0, e1, e2, n0, n1, n2, mat, materials):
        self.v0, self.e1, self.e2 = v0, e1, e2
        self.n0, self.n1, self.n2 = n0, n1, n2
        self.mat = mat
        self.materials = materials

    @property
    def count(self) -> int:
        return self.v0.shape[0]


def world_transforms(obj) -> np.ndarray:
    """(K, 4, 4) world transforms of one scene object: its instance
    transform times each of its sub-instance matrices."""
    inst = np.asarray(obj["instance"], np.float64)
    sub = obj.get("sub")
    sub = np.eye(4)[None] if sub is None else np.asarray(sub, np.float64)
    return np.einsum("pq,kqr->kpr", inst, sub)


def bake(scene: dict, device, dtype=torch.float32) -> Triangles:
    """World triangles of every object of a benchmark scene, in object
    order, then sub-instance, then the mesh's triangle order. The
    transforms apply in float64 and round once."""
    parts = {k: [] for k in ("v0", "e1", "e2", "n0", "n1", "n2", "mat")}
    materials = []
    for obj in scene["objects"]:
        m = obj["mesh"]
        p = np.asarray(m["positions"], np.float64)
        n = np.asarray(m["normals"], np.float64)
        tri = np.asarray(m["triangles"], np.int64)
        slot = len(materials)
        mat = obj["material"]
        materials.append([*mat["albedo"], mat["roughness"], mat["metallic"],
                          mat.get("emission", 0.0)])
        for w in world_transforms(obj):
            rot, tr = w[:3, :3], w[:3, 3]
            wp = p @ rot.T + tr
            wn = n @ rot.T
            a, b, c = wp[tri[:, 0]], wp[tri[:, 1]], wp[tri[:, 2]]
            parts["v0"].append(a)
            parts["e1"].append(b - a)
            parts["e2"].append(c - a)
            for k in range(3):
                parts[f"n{k}"].append(wn[tri[:, k]])
            parts["mat"].append(np.full(tri.shape[0], slot))

    def t(key, dt):
        return torch.tensor(np.concatenate(parts[key]), dtype=dt, device=device)

    return Triangles(*(t(k, dtype) for k in ("v0", "e1", "e2", "n0", "n1", "n2")),
                     t("mat", torch.int64),
                     torch.tensor(materials, dtype=dtype, device=device))


def trace(tris: Triangles, o, d, tmin):
    """Closest hit of rays (R, 3) against every triangle: (t (R,), hit
    (R,) bool, shading normal before normalization (R, 3), material (R,)).
    ``tmin`` is a number or an (R,) tensor."""
    r = o.shape[0]
    dtype = o.dtype
    best_t = torch.full((r,), _TMAX, dtype=dtype, device=o.device)
    nrm = torch.zeros((r, 3), dtype=dtype, device=o.device)
    mat = torch.zeros((r,), dtype=torch.int64, device=o.device)
    if r == 0:
        return best_t, best_t < _HIT_MAX, nrm, mat
    tmin = torch.as_tensor(tmin, dtype=dtype, device=o.device).expand(r)
    step = max(1, _BLOCK // tris.count)
    v0, e1, e2 = (x[None] for x in (tris.v0, tris.e1, tris.e2))
    for r0 in range(0, r, step):
        oo, dd = o[r0:r0 + step, None, :], d[r0:r0 + step, None, :]
        pv = _cross(dd, e2)
        det = _dot(e1, pv)
        ok = torch.abs(det) > _DET_EPS
        inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
        tv = oo - v0
        u = _dot(tv, pv) * inv
        qv = _cross(tv, e1)
        v = _dot(dd, qv) * inv
        t = _dot(e2, qv) * inv
        ok = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        ok = ok & (t > tmin[r0:r0 + step, None]) & (t <= _TMAX)
        tk = torch.where(ok, t, torch.full_like(t, math.inf))
        k = torch.argmin(tk, dim=1)  # the first, lowest index, of equal t
        bt = tk.gather(1, k[:, None])[:, 0]
        hit = bt < math.inf
        uk = u.gather(1, k[:, None])[:, 0][:, None]
        vk = v.gather(1, k[:, None])[:, 0][:, None]
        n0 = tris.n0[k]
        blend = n0 + uk * (tris.n1[k] - n0) + vk * (tris.n2[k] - n0)
        best_t[r0:r0 + step] = torch.where(hit, bt, best_t[r0:r0 + step])
        nrm[r0:r0 + step] = torch.where(hit[:, None], blend, nrm[r0:r0 + step])
        mat[r0:r0 + step] = torch.where(hit, tris.mat[k], mat[r0:r0 + step])
    return best_t, best_t < _HIT_MAX, nrm, mat


def radiance(tris: Triangles, sky, origin, direction, rng, tmin0, bounces, dtype):
    """Trace ``bounces`` + 1 segments of every ray. Returns (radiance
    (R, 3), first-hit normal (R, 3), albedo (R, 3), position (R, 3), live
    ray-segments): the flat ``sky`` (3,) radiance on a miss, the first
    segment's AOVs as the reference's frame buffers hold them."""
    r = origin.shape[0]
    dev = origin.device
    o, d = origin.to(dtype).clone(), direction.to(dtype).clone()
    rng = rng.clone()
    thr = torch.ones((r, 3), dtype=dtype, device=dev)
    rad = torch.zeros((r, 3), dtype=dtype, device=dev)
    live = torch.arange(r, device=dev)
    aov = None
    segments = 0
    for s in range(bounces + 1):
        segments += live.numel()
        lo, ld, lt, lr = o[live], d[live], thr[live], rng[live]
        bt, hit, bn, mid = trace(tris, lo, ld, tmin0 if s == 0 else _BOUNCE_TMIN)
        m = tris.materials[mid]
        alb, ro, me, em = m[:, 0:3], m[:, 3], m[:, 4], m[:, 5]
        n = bn * (1.0 / torch.sqrt(torch.clamp(_dot(bn, bn), min=1e-20)))[:, None]
        n = torch.where((_dot(ld, n) > 0.0)[:, None], -n, n)
        add = torch.where(hit[:, None], lt * em[:, None] * alb, lt * sky)
        rad[live] = rad[live] + add
        hp = lo + bt[:, None] * ld
        if s == 0:
            aov = (torch.where(hit[:, None], n, torch.zeros_like(n)),
                   torch.where(hit[:, None], alb, sky.expand_as(alb)),
                   torch.where(hit[:, None], hp, torch.full_like(hp, _NO_HIT)))
        if s == bounces:
            break
        refl = ld - 2.0 * _dot(ld, n)[:, None] * n
        lr, nd = sample_cone(lr, refl, me, dtype)
        f = torch.where(me >= 0.0, (me + 2.0) / (me + 1.0), torch.ones_like(me))
        w = torch.clamp(torch.abs(_dot(n, nd)) * ro + (1.0 - ro) * f, 0.0, 1.0)
        keep = hit
        idx = live[keep]
        o[idx], d[idx] = hp[keep], nd[keep]
        thr[idx] = (lt * alb * w[:, None])[keep]
        rng[idx] = lr[keep]
        live = idx
    return rad, aov[0], aov[1], aov[2], segments


# ----------------------------------------------------------------- camera


def _perspective(fovy, aspect, near, far):
    f = 1.0 / np.tan(fovy / 2.0)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2.0 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


def _look_at(eye, center, up):
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def _quat_rotate(q, v):
    w, x, y, z = q
    u = np.array([x, y, z], np.float32)
    return (2.0 * (u @ v) * u + (w * w - u @ u) * v
            + 2.0 * w * np.cross(u, v)).astype(np.float32)


def camera_matrix(camera: dict, width: int, height: int) -> np.ndarray:
    """The (4, 4) float32 inverse projection-view of a camera given by
    ``eye``, ``target`` and ``fov`` (degrees, the full vertical angle;
    the projection takes half of it), through the eye-target quaternion."""
    position = np.asarray(camera["eye"], np.float32)
    target = np.asarray(camera["target"], np.float32)
    front = target - position
    front = front / np.linalg.norm(front)
    up = np.asarray((0.0, 1.0, 0.0), np.float32)
    right = np.cross(front, up)
    right /= np.linalg.norm(right)
    true_up = np.cross(right, front)
    m = np.stack([right, true_up, -front], axis=1)
    w = np.sqrt(max(0.0, 1.0 + m[0, 0] + m[1, 1] + m[2, 2])) / 2.0
    q = np.array([w, (m[2, 1] - m[1, 2]) / (4 * w), (m[0, 2] - m[2, 0]) / (4 * w),
                  (m[1, 0] - m[0, 1]) / (4 * w)], np.float32)
    front = _quat_rotate(q, np.array([0, 0, -1], np.float32))
    front /= np.linalg.norm(front)
    up = _quat_rotate(q, np.array([0, 1, 0], np.float32))
    up /= np.linalg.norm(up)
    proj = _perspective(np.radians(camera["fov"] * 0.5), float(width) / float(height),
                        0.1, 100.0)
    view = _look_at(position, position + front, up)
    return np.linalg.inv(proj @ view).astype(np.float32)


def camera_rays(inv: torch.Tensor, rng, ix, iy, width: int, height: int, dtype):
    """Jittered primary rays of pixels (ix, iy) (float tensors) with a
    pinhole (aperture 0, focal length 1). Returns (rng, origin, dir)."""
    half_x = float(np.float32(width / 2.0))
    half_y = float(np.float32(height / 2.0))
    rng, jx = lcg_next(rng, dtype)
    rng, jy = lcg_next(rng, dtype)
    hx = torch.full((), half_x, dtype=dtype, device=ix.device)
    hy = torch.full((), half_y, dtype=dtype, device=ix.device)
    sx = (ix.to(dtype) + jx - hx) / hx
    sy = (iy.to(dtype) + jy - hy) / hy
    inv = inv.to(dtype)

    def apply(z):
        col = sx[:, None] * inv[:, 0] + sy[:, None] * inv[:, 1] + z * inv[:, 2] + inv[:, 3]
        return col[:, :3] / col[:, 3:4]

    start = apply(-1.0)
    d = _normalize(apply(1.0) - start)
    rng, _ = lcg_next(rng, dtype)  # the aperture angle: no effect at aperture 0
    return rng, start, _normalize((start + d) - start)


def sky_radiance(env: dict, device, dtype) -> torch.Tensor:
    """The flat environment: max(colour x skylight, 0) ^ (1 / gamma)."""
    c = np.maximum(np.asarray(env["color"], np.float64) * env["skylight_intensity"], 0.0)
    return torch.tensor((c ** (1.0 / env["gamma"])).astype(np.float32), dtype=dtype,
                        device=device)


def render_pixels(tris, scene: dict, width: int, height: int, bounces: int,
                  pixels: torch.Tensor, frame_ids, dtype=torch.float32):
    """Linear radiance and first-hit AOVs of ``pixels`` (P,) (row-major
    index, row 0 at the bottom) for each frame of ``frame_ids``: tensors
    (F, P, 3) of colour, normal, albedo and the live ray-segments."""
    dev = pixels.device
    inv = torch.tensor(camera_matrix(scene["camera"], width, height), device=dev)
    sky = sky_radiance(scene["environment"], dev, dtype)
    frames = torch.tensor([f & MASK32 for f in frame_ids], dtype=torch.int64, device=dev)
    f_all = frames[:, None].expand(-1, pixels.numel()).reshape(-1)
    p_all = pixels[None, :].expand(frames.numel(), -1).reshape(-1)
    rng = lcg_init(p_all, f_all)
    ix = (p_all % width).to(torch.float32)
    iy = torch.div(p_all, width, rounding_mode="floor").to(torch.float32)
    rng, o, d = camera_rays(inv, rng, ix, iy, width, height, dtype)
    col, nrm, alb, _, segs = radiance(tris, sky, o, d, rng, 0.0, bounces, dtype)
    shape = (frames.numel(), pixels.numel(), 3)
    return col.reshape(shape), nrm.reshape(shape), alb.reshape(shape), segs


# the camera's gamma, 2.2 as float32, and its reciprocal rounded to float32
GAMMA = float(np.float32(2.2))
INV_GAMMA = float(np.float32(1.0) / np.float32(2.2))


def accumulate(colors, start_frame: int, prev=None, frames_per_call: int = 1):
    """Progressive accumulation of linear colours (F, P, 3), starting
    from frame id ``start_frame`` and the gamma-encoded history ``prev``
    (zeros if None): per frame, history weighted by the frame id (only
    once the id exceeds 1), then gamma-encoded. Returns the encoded colour
    after every ``frames_per_call``-th frame, (F / frames_per_call, P, 3),
    and the history after the last frame."""
    dtype = colors.dtype
    cur = torch.zeros_like(colors[0]) if prev is None else prev
    out = []
    fid = start_frame
    for k in range(colors.shape[0]):
        c = colors[k]
        if fid > 1:
            back = torch.pow(torch.clamp(cur, min=0.0).to(torch.float64), GAMMA).to(dtype)
            c = (c + fid * back) / torch.full((), fid + 1.0, dtype=dtype, device=c.device)
        cur = torch.pow(torch.clamp(c, min=0.0).to(torch.float64), INV_GAMMA).to(dtype)
        fid += 1
        if (k + 1) % frames_per_call == 0:
            out.append(cur)
    return torch.stack(out), cur


# ----------------------------------------------------------------- probes


def probe_triangles(items, device, dtype=torch.float32):
    """Probe corners of the estimator's (mesh, 4x4 transform) items, one
    probe per triangle in item order: positions and normals (P, 3, 3)
    (corner, xyz) and the area of each triangle (P,) float64 (Heron)."""
    pos, nrm = [], []
    for m, w in items:
        w = np.asarray(w, np.float64)
        p = np.asarray(m["positions"], np.float64) @ w[:3, :3].T + w[:3, 3]
        n = np.asarray(m["normals"], np.float64) @ w[:3, :3].T
        t = np.asarray(m["triangles"], np.int64)
        pos.append(np.stack([p[t[:, 0]], p[t[:, 1]], p[t[:, 2]]], axis=1))
        nrm.append(np.stack([n[t[:, 0]], n[t[:, 1]], n[t[:, 2]]], axis=1))
    pos, nrm = np.concatenate(pos), np.concatenate(nrm)
    a = np.linalg.norm(pos[:, 0] - pos[:, 1], axis=-1)
    b = np.linalg.norm(pos[:, 1] - pos[:, 2], axis=-1)
    c = np.linalg.norm(pos[:, 2] - pos[:, 0], axis=-1)
    s = (a + b + c) * 0.5
    area = np.sqrt(np.maximum(s * (s - a) * (s - b) * (s - c), 0.0))
    return (torch.tensor(pos, dtype=dtype, device=device),
            torch.tensor(nrm, dtype=dtype, device=device),
            torch.tensor(area, dtype=torch.float64, device=device))


def estimate_probes(tris, scene: dict, pos, nrm, probe_index, seed: int,
                    samples: int, bounces: int, dtype=torch.float32,
                    push: float = 1e-3, tmin: float = 1e-3):
    """Energy (P, 3) and mean direction (P, 3) of the probes
    ``probe_index`` (P,) over both faces and ``samples`` hemisphere
    samples each, with estimator seed ``seed``: a uniform barycentric
    point (two raw draws), the face normal's hemisphere, a path of
    ``bounces`` bounces, E x |N.L| averaged, directions weighted by |E|."""
    dev = pos.device
    p = probe_index.numel()
    face = torch.arange(2, device=dev)[None, :, None]
    samp = torch.arange(samples, device=dev)[None, None, :]
    ray_id = (probe_index[:, None, None] * (2 * samples) + face * samples + samp) & MASK32
    rng = lcg_init(ray_id, torch.tensor(seed & MASK32, device=dev))
    rng, ca = lcg_next(rng, dtype)
    rng, cb = lcg_next(rng, dtype)
    w = (1.0 - ca - cb)[..., None]
    ca, cb = ca[..., None], cb[..., None]
    pp, nn = pos[probe_index].to(dtype), nrm[probe_index].to(dtype)

    def blend(corners):
        return (w * corners[:, None, None, 0] + ca * corners[:, None, None, 1]
                + cb * corners[:, None, None, 2])

    position = blend(pp)
    normal = blend(nn) * torch.where(face == 0, 1.0, -1.0).to(dtype)[..., None]
    rng, ray_dir = sample_cone(rng, normal, None, dtype)
    origin = position + normal * push
    sky = sky_radiance(scene["environment"], dev, dtype)
    n = p * 2 * samples
    rad, _, _, _, segs = radiance(tris, sky, origin.reshape(n, 3), ray_dir.reshape(n, 3),
                                  rng.reshape(n), tmin, bounces, dtype)
    rad = rad.reshape(p, 2, samples, 3)
    ndotl = torch.abs(_dot(normal, ray_dir))[..., None]
    e = rad * ndotl
    wdir = ray_dir * torch.sqrt(_dot(e, e))[..., None]
    energy = e.sum(dim=(1, 2)) / (2 * samples)
    total = wdir.sum(dim=(1, 2))
    norm = torch.sqrt(_dot(total, total))[:, None]
    direction = torch.where(norm > 0, total / torch.clamp(norm, min=1e-20),
                            torch.zeros_like(total))
    return energy, direction, segs
