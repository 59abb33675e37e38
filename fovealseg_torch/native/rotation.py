"""Rotation / Slerp work-alike for the spatial.transform surface
(counterpart of ``fovealseg_tpu/native/rotation.py``, a numpy copy).

Vectorized NumPy implementation of the scipy API slice of the reference's
vendored ``spatial/transform``: quaternion (scalar-last) storage; from/as
quat, matrix, rotvec, euler; apply; inv; composition; magnitude; mean;
align_vectors; identity; random; Slerp; ``RotationSpline``;
``create_group``. Closed-form Euler extraction (Tait-Bryan arcsin form,
proper Euler arccos form, extrinsic by sequence reversal).
"""

from __future__ import annotations

import numpy as np

_AXIS = {"x": 0, "y": 1, "z": 2}


def _elem_matrix(axis: int, angle: np.ndarray) -> np.ndarray:
    """Rotation matrices about a coordinate axis; angle [...] -> [..., 3, 3]."""
    c, s = np.cos(angle), np.sin(angle)
    o, z = np.ones_like(c), np.zeros_like(c)
    if axis == 0:
        rows = [o, z, z, z, c, -s, z, s, c]
    elif axis == 1:
        rows = [c, z, s, z, o, z, -s, z, c]
    else:
        rows = [c, -s, z, s, c, z, z, z, o]
    return np.stack(rows, axis=-1).reshape(angle.shape + (3, 3))


def _quat_mul(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Hamilton product of scalar-last quaternions ([..., 4])."""
    px, py, pz, pw = np.moveaxis(p, -1, 0)
    qx, qy, qz, qw = np.moveaxis(q, -1, 0)
    return np.stack(
        [
            pw * qx + px * qw + py * qz - pz * qy,
            pw * qy - px * qz + py * qw + pz * qx,
            pw * qz + px * qy - py * qx + pz * qw,
            pw * qw - px * qx - py * qy - pz * qz,
        ],
        axis=-1,
    )


def _normalize(q: np.ndarray) -> np.ndarray:
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


class Rotation:
    """Rotation in 3-D, stored as normalized scalar-last quaternions [n, 4]."""

    def __init__(self, quat, normalize: bool = True, copy: bool = True):
        quat = np.asarray(quat, dtype=np.float64)
        self._single = quat.ndim == 1
        quat = np.atleast_2d(quat)
        if quat.shape[-1] != 4:
            raise ValueError("quaternions must be [..., 4] scalar-last")
        if normalize:
            quat = _normalize(quat)
        elif copy:
            quat = quat.copy()
        self._quat = quat

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_quat(cls, quat) -> "Rotation":
        return cls(quat, normalize=True)

    @classmethod
    def from_matrix(cls, matrix) -> "Rotation":
        """Largest-component (Shepperd) quaternion extraction; vectorized."""
        m = np.asarray(matrix, dtype=np.float64)
        single = m.ndim == 2
        if single:
            m = m[None]
        n = m.shape[0]
        q = np.empty((n, 4))
        tr = np.einsum("nii->ni", m)  # diagonal [n, 3]
        # candidate squared components: (x, y, z, w) * 4
        cand = np.stack(
            [
                1.0 + tr[:, 0] - tr[:, 1] - tr[:, 2],
                1.0 - tr[:, 0] + tr[:, 1] - tr[:, 2],
                1.0 - tr[:, 0] - tr[:, 1] + tr[:, 2],
                1.0 + tr[:, 0] + tr[:, 1] + tr[:, 2],
            ],
            axis=-1,
        )
        choice = np.argmax(cand, axis=-1)
        for i in range(n):
            M = m[i]
            c = choice[i]
            if c == 3:
                w = 0.5 * np.sqrt(cand[i, 3])
                q[i] = [
                    (M[2, 1] - M[1, 2]) / (4 * w),
                    (M[0, 2] - M[2, 0]) / (4 * w),
                    (M[1, 0] - M[0, 1]) / (4 * w),
                    w,
                ]
            else:
                j, k = (c + 1) % 3, (c + 2) % 3
                s = 0.5 * np.sqrt(cand[i, c])
                vec = np.empty(3)
                vec[c] = s
                vec[j] = (M[j, c] + M[c, j]) / (4 * s)
                vec[k] = (M[k, c] + M[c, k]) / (4 * s)
                q[i] = [vec[0], vec[1], vec[2], (M[k, j] - M[j, k]) / (4 * s)]
        q = _normalize(q)
        return cls(q[0] if single else q, normalize=False, copy=False)

    @classmethod
    def from_rotvec(cls, rotvec) -> "Rotation":
        rv = np.asarray(rotvec, dtype=np.float64)
        single = rv.ndim == 1
        rv = np.atleast_2d(rv)
        angle = np.linalg.norm(rv, axis=-1)
        small = angle < 1e-8
        # sin(a/2)/a with Taylor fallback near zero
        scale = np.where(
            small, 0.5 - angle**2 / 48.0, np.sin(angle / 2.0) / np.where(small, 1.0, angle)
        )
        quat = np.concatenate(
            [rv * scale[..., None], np.cos(angle / 2.0)[..., None]], axis=-1
        )
        return cls(quat[0] if single else quat, normalize=False, copy=False)

    @classmethod
    def from_euler(cls, seq: str, angles, degrees: bool = False) -> "Rotation":
        intrinsic = seq.isupper()
        axes = [_AXIS[c] for c in seq.lower()]
        if not 1 <= len(axes) <= 3:
            raise ValueError("sequence must have 1-3 axes")
        if any(axes[i] == axes[i + 1] for i in range(len(axes) - 1)):
            raise ValueError("consecutive axes must differ")
        ang = np.asarray(angles, dtype=np.float64)
        if degrees:
            ang = np.deg2rad(ang)
        if len(axes) == 1:
            # scalar -> one rotation; a 1-D multi-angle array is rejected
            # below, matching the installed scipy (1.17) oracle — older
            # scipy (<=1.6, the reference's vendored era) accepted (n,) as
            # a stack for single-axis sequences
            ang = ang.reshape(ang.shape + (1,)) if ang.ndim == 0 else ang
        single = ang.ndim <= 1
        ang = np.atleast_2d(ang)
        if ang.shape[-1] != len(axes):
            raise ValueError("angle count must match sequence length")
        # elementary quaternions composed per convention:
        # intrinsic: q = q1 * q2 * q3 ; extrinsic: q = q3 * q2 * q1
        quats = []
        for i, ax in enumerate(axes):
            half = ang[:, i] / 2.0
            q = np.zeros(ang.shape[:-1] + (4,))
            q[..., ax] = np.sin(half)
            q[..., 3] = np.cos(half)
            quats.append(q)
        order = quats if intrinsic else list(reversed(quats))
        total = order[0]
        for q in order[1:]:
            total = _quat_mul(total, q)
        return cls(total[0] if single else total, normalize=True)

    @classmethod
    def identity(cls, num: int | None = None) -> "Rotation":
        if num is None:
            return cls(np.array([0.0, 0.0, 0.0, 1.0]), normalize=False)
        q = np.zeros((num, 4))
        q[:, 3] = 1.0
        return cls(q, normalize=False, copy=False)

    @classmethod
    def random(cls, num: int | None = None, random_state=None) -> "Rotation":
        rng = np.random.default_rng(random_state)
        n = 1 if num is None else num
        q = rng.normal(size=(n, 4))
        q = _normalize(q)
        return cls(q[0] if num is None else q, normalize=False, copy=False)

    @classmethod
    def align_vectors(cls, a, b, weights=None):
        """Kabsch/Wahba solve: rotation taking b onto a; returns (R, rssd)."""
        a = np.atleast_2d(np.asarray(a, dtype=np.float64))
        b = np.atleast_2d(np.asarray(b, dtype=np.float64))
        w = np.ones(len(a)) if weights is None else np.asarray(weights, float)
        B = np.einsum("n,ni,nj->ij", w, a, b)
        U, S, Vt = np.linalg.svd(B)
        d = np.sign(np.linalg.det(U @ Vt))
        M = U @ np.diag([1.0, 1.0, d]) @ Vt
        rot = cls.from_matrix(M)
        # residual sum of squared distances
        resid = a - np.einsum("ij,nj->ni", M, b)
        rssd = np.sqrt(max(np.sum(w[:, None] * resid**2), 0.0))
        return rot, rssd

    # -- representations ----------------------------------------------------

    def as_quat(self) -> np.ndarray:
        q = self._quat.copy()
        return q[0] if self._single else q

    def as_matrix(self) -> np.ndarray:
        x, y, z, w = np.moveaxis(self._quat, -1, 0)
        xx, yy, zz = x * x, y * y, z * z
        xy, xz, yz = x * y, x * z, y * z
        wx, wy, wz = w * x, w * y, w * z
        m = np.stack(
            [
                1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
                2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
                2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
            ],
            axis=-1,
        ).reshape(self._quat.shape[:-1] + (3, 3))
        return m[0] if self._single else m

    def as_rotvec(self) -> np.ndarray:
        q = self._quat
        # take the w >= 0 representative so the angle is in [0, pi]
        q = np.where(q[..., 3:4] < 0, -q, q)
        norm = np.linalg.norm(q[..., :3], axis=-1)
        angle = 2.0 * np.arctan2(norm, q[..., 3])
        small = angle < 1e-8
        scale = np.where(
            small, 2.0 + angle**2 / 12.0, angle / np.where(small, 1.0, np.sin(angle / 2.0))
        )
        rv = q[..., :3] * scale[..., None]
        return rv[0] if self._single else rv

    def as_euler(self, seq: str, degrees: bool = False) -> np.ndarray:
        if len(seq) != 3:
            raise ValueError("as_euler requires a 3-axis sequence")
        intrinsic = seq.isupper()
        s = seq.lower()
        if not intrinsic:
            s = s[::-1]  # extrinsic(abc) == intrinsic(cba) with angles reversed
        i, j = _AXIS[s[0]], _AXIS[s[1]]
        proper = s[0] == s[2]
        k = ({0, 1, 2} - {i, j}).pop() if proper else _AXIS[s[2]]
        eps = +1.0 if (j - i) % 3 == 1 else -1.0  # cyclic permutation sign
        m = self.as_matrix()
        m = m[None] if self._single else m
        if proper:
            b = np.arccos(np.clip(m[:, i, i], -1.0, 1.0))
            safe = np.abs(np.sin(b)) > 1e-7
            a = np.where(safe, np.arctan2(m[:, j, i], -eps * m[:, k, i]), 0.0)
            c = np.where(safe, np.arctan2(m[:, i, j], eps * m[:, i, k]), 0.0)
        else:
            b = np.arcsin(np.clip(eps * m[:, i, k], -1.0, 1.0))
            safe = np.abs(np.cos(b)) > 1e-7
            a = np.where(safe, np.arctan2(-eps * m[:, j, k], m[:, k, k]), 0.0)
            c = np.where(safe, np.arctan2(-eps * m[:, i, j], m[:, i, i]), 0.0)
        if not safe.all():
            # gimbal lock: with c := 0 the rotation is exactly
            # R = Ri(a) Rj(b) with b known, so a is read off the elementary
            # rotation M2 = m @ Rj(-b): about axis i, M2[q, p] = sin(a),
            # M2[p, p] = cos(a) with (p, q) = the cyclic successors of i.
            # (A sign-blind closed form here mis-reconstructs half the lock
            # cases because which of a+c / a-c is observable flips with
            # sign(b).)
            p, q = (i + 1) % 3, (i + 2) % 3
            m2 = m @ _elem_matrix(j, -b)
            a = np.where(safe, a, np.arctan2(m2[:, q, p], m2[:, p, p]))
        ang = np.stack([a, b, c], axis=-1)
        if not intrinsic:
            ang = ang[:, ::-1]
        if degrees:
            ang = np.rad2deg(ang)
        return ang[0] if self._single else ang

    # -- operations ---------------------------------------------------------

    def apply(self, vectors, inverse: bool = False) -> np.ndarray:
        v = np.asarray(vectors, dtype=np.float64)
        vsingle = v.ndim == 1
        v = np.atleast_2d(v)
        m = self.as_matrix()
        if self._single:
            out = v @ (m if inverse else m.T)
        else:
            out = np.einsum("nij,nj->ni", np.swapaxes(m, -1, -2) if inverse else m, v)
        return out[0] if (vsingle and self._single) else out

    def inv(self) -> "Rotation":
        q = self._quat * np.array([-1.0, -1.0, -1.0, 1.0])
        return Rotation(q[0] if self._single else q, normalize=False, copy=False)

    def __mul__(self, other: "Rotation") -> "Rotation":
        q = _quat_mul(self._quat, other._quat)
        single = self._single and other._single
        return Rotation(q[0] if single else q, normalize=True)

    def magnitude(self):
        q = self._quat
        ang = 2.0 * np.arctan2(np.linalg.norm(q[..., :3], axis=-1), np.abs(q[..., 3]))
        return float(ang[0]) if self._single else ang

    def mean(self, weights=None) -> "Rotation":
        """Chordal L2 mean (Markley): principal eigenvector of sum w q qT."""
        q = self._quat
        w = np.ones(len(q)) if weights is None else np.asarray(weights, float)
        A = np.einsum("n,ni,nj->ij", w, q, q)
        vals, vecs = np.linalg.eigh(A)
        return Rotation(vecs[:, -1], normalize=True)

    def __len__(self) -> int:
        if self._single:
            raise TypeError("single rotation has no len()")
        return len(self._quat)

    def __getitem__(self, idx) -> "Rotation":
        if self._single:
            raise TypeError("single rotation is not subscriptable")
        return Rotation(self._quat[idx], normalize=False)


class Slerp:
    """Spherical linear interpolation over keyframe rotations at given times."""

    def __init__(self, times, rotations: Rotation):
        self.times = np.asarray(times, dtype=np.float64)
        if len(rotations) != len(self.times):
            raise ValueError("times and rotations must have equal length")
        if np.any(np.diff(self.times) <= 0):
            raise ValueError("times must be strictly increasing")
        self.rotations = rotations

    def __call__(self, t) -> Rotation:
        t = np.asarray(t, dtype=np.float64)
        single = t.ndim == 0
        t = np.atleast_1d(t)
        if np.any(t < self.times[0]) or np.any(t > self.times[-1]):
            raise ValueError("interpolation times out of range")
        idx = np.clip(np.searchsorted(self.times, t, side="right") - 1, 0,
                      len(self.times) - 2)
        t0, t1 = self.times[idx], self.times[idx + 1]
        tau = (t - t0) / (t1 - t0)
        r0 = self.rotations[idx]
        r1 = self.rotations[idx + 1]
        delta = (r0.inv() * r1).as_rotvec()
        out = r0 * Rotation.from_rotvec(delta * tau[:, None])
        return out[0] if single else out


# ---------------------------------------------------------------------------
# Rotation-vector <-> angular-rate kinematics (shared by RotationSpline).
#
# With r(t) the rotation vector of a moving frame and w(t) its angular rate,
# rdot = T(r) w and w = Tinv(r) rdot, where (theta = |r|, S = skew(r)):
#   T(r)    = I + S/2 + c(theta) S^2,  c = (1 - (theta/2) cot(theta/2)) / theta^2
#   Tinv(r) = I - k1 S + k2 S^2,       k1 = (1-cos)/th^2, k2 = (th-sin)/th^3
# Small-angle branches use the Taylor series. Angular acceleration is
# a = Tinv(r) rddot + beta(r, rdot) with the quadratic term beta below —
# standard attitude kinematics (the math the reference's vendored
# spatial/transform/_rotation_spline.py also implements).
# ---------------------------------------------------------------------------


def _skew(r: np.ndarray) -> np.ndarray:
    """[n,3] -> [n,3,3] skew-symmetric (cross-product) matrices."""
    z = np.zeros(len(r))
    rx, ry, rz = r[:, 0], r[:, 1], r[:, 2]
    return np.stack(
        [z, -rz, ry, rz, z, -rx, -ry, rx, z], axis=-1
    ).reshape(-1, 3, 3)


def _rate_to_rotvec_dot(r: np.ndarray) -> np.ndarray:
    """T(r): angular rate -> rotation-vector derivative, [n,3,3]."""
    th = np.linalg.norm(r, axis=1)
    big = th > 1e-4
    c = np.where(
        big,
        (1.0 - 0.5 * th / np.tan(np.where(big, th, 1.0) / 2.0)) / np.where(big, th, 1.0) ** 2,
        1.0 / 12.0 + th**2 / 720.0,
    )
    s = _skew(r)
    return np.eye(3) + 0.5 * s + c[:, None, None] * (s @ s)


def _rotvec_dot_to_rate(r: np.ndarray) -> np.ndarray:
    """Tinv(r): rotation-vector derivative -> angular rate, [n,3,3]."""
    th = np.linalg.norm(r, axis=1)
    big = th > 1e-4
    thb = np.where(big, th, 1.0)
    k1 = np.where(big, (1.0 - np.cos(thb)) / thb**2, 0.5 - th**2 / 24.0)
    k2 = np.where(big, (thb - np.sin(thb)) / thb**3, 1.0 / 6.0 - th**2 / 120.0)
    s = _skew(r)
    return np.eye(3) - k1[:, None, None] * s + k2[:, None, None] * (s @ s)


def _accel_quadratic_term(r: np.ndarray, rdot: np.ndarray) -> np.ndarray:
    """beta(r, rdot): the quadratic-in-rdot part of the angular acceleration."""
    th = np.linalg.norm(r, axis=1)
    big = th > 1e-4
    thb = np.where(big, th, 1.0)
    k1 = np.where(
        big, (-thb * np.sin(thb) - 2.0 * (np.cos(thb) - 1.0)) / thb**4,
        1.0 / 12.0 - th**2 / 180.0,
    )
    k2 = np.where(
        big, (-2.0 * thb + 3.0 * np.sin(thb) - thb * np.cos(thb)) / thb**5,
        # 12604 intentionally mirrors scipy's _rotation_spline.py small-angle
        # series (the true Taylor coefficient is th**2/1260; the difference is
        # below float noise at th < 1e-4) — kept for oracle bit-parity
        -1.0 / 60.0 + th**2 / 12604.0,
    )
    k3 = np.where(big, (thb - np.sin(thb)) / thb**3, 1.0 / 6.0 - th**2 / 120.0)
    dp = np.sum(r * rdot, axis=1, keepdims=True)
    cp = np.cross(r, rdot)
    return (dp * (k1[:, None] * cp + k2[:, None] * np.cross(r, cp))
            + k3[:, None] * np.cross(rdot, cp))


def _solve_block_tridiag(sub, diag, sup, b):
    """Thomas algorithm over 3x3 blocks.

    sub[i-1] couples unknown i to i-1 (i in 1..m-1), diag[i] is the i-th
    diagonal block, sup[i] couples i to i+1 (i in 0..m-2); b is [m,3].
    """
    m = len(b)
    diag = diag.copy()
    b = b.copy()
    for i in range(1, m):
        w = sub[i - 1] @ np.linalg.inv(diag[i - 1])
        diag[i] = diag[i] - w @ sup[i - 1]
        b[i] = b[i] - w @ b[i - 1]
    x = np.empty_like(b)
    x[-1] = np.linalg.solve(diag[-1], b[-1])
    for i in range(m - 2, -1, -1):
        x[i] = np.linalg.solve(diag[i], b[i] - sup[i] @ x[i + 1])
    return x


class RotationSpline:
    """C2 rotation interpolation: per-segment cubic rotation vectors with
    continuous angular rate and acceleration across knots.

    The spatial/transform ``RotationSpline`` surface of the reference's
    vendored scipy. Semantics match
    scipy's: segment i carries the cubic relative rotation vector from
    R_i to R_{i+1}; knot angular rates solve the acceleration-continuity
    system (a nonlinear fixed point, iterated over a linearized 3x3-block
    tridiagonal solve) with the chord rates of the end segments as fixed
    boundary rates. ``__call__(t, order)`` returns interpolated Rotations
    (0), angular rate (1) or angular acceleration (2); oracle-tested
    against scipy.spatial.transform.RotationSpline.
    """

    MAX_ITER = 10
    TOL = 1e-9

    def __init__(self, times, rotations: Rotation):
        times = np.asarray(times, dtype=np.float64)
        if times.ndim != 1 or len(times) != len(rotations):
            raise ValueError("times must be 1-D with one entry per rotation")
        dt = np.diff(times)
        if np.any(dt <= 0):
            raise ValueError("times must be strictly increasing")

        # relative rotation vector per segment; chord rates as boundary/initial
        r = (rotations[:-1].inv() * rotations[1:]).as_rotvec()
        w = r / dt[:, None]
        if len(times) == 2:
            rdot_end = w.copy()  # single linear segment
            w_knot = w
        else:
            w0 = w[0].copy()  # first knot keeps the segment-0 chord rate
            w_end, rdot_end = self._solve_rates(dt, w, r)
            w_knot = np.vstack([w0[None], w_end[:-1]])

        d = dt[:, None]
        # r_i(tau) = w tau + b tau^2 + c tau^3 on [0, dt_i]; rdot at the far
        # end must equal T(r_i) w_{i+1} (rate continuity across the knot)
        self._c3 = (d * (w_knot + rdot_end) - 2.0 * r) / d**3
        self._c2 = (3.0 * r - d * (2.0 * w_knot + rdot_end)) / d**2
        self._c1 = w_knot
        self.times = times
        self.rotations = rotations

    def _solve_rates(self, dt, w, r):
        """Fixed-point iteration for knot angular rates.

        ``w`` enters as chord rates; during iteration w[i] estimates the
        rate at knot i+1 (the far end of segment i); the first knot's rate
        stays the segment-0 chord rate, the last knot's the last chord rate.
        """
        w0 = w[0].copy()
        T = _rate_to_rotvec_dot(r)
        Tinv = _rotvec_dot_to_rate(r)

        # acceleration continuity at interior knot i (end of segment i-1 =
        # start of segment i), eliminated to rates: block-tridiagonal system
        sub = 2.0 * Tinv[1:-1] / dt[1:-1, None, None]
        sup = 2.0 * T[1:-1] / dt[1:-1, None, None]
        diag = (4.0 * (1.0 / dt[:-1] + 1.0 / dt[1:]))[:, None, None] * np.eye(3)
        rhs0 = 6.0 * (r[:-1] / dt[:-1, None] ** 2 + r[1:] / dt[1:, None] ** 2)
        rhs0[0] -= 2.0 / dt[0] * (Tinv[0] @ w0)
        rhs0[-1] -= 2.0 / dt[-1] * (T[-1] @ w[-1])

        for _ in range(self.MAX_ITER):
            rdot = np.einsum("nij,nj->ni", T, w)
            rhs = rhs0 - _accel_quadratic_term(r[:-1], rdot[:-1])
            w_new = _solve_block_tridiag(sub, diag, sup, rhs)
            delta = np.abs(w_new - w[:-1])
            w[:-1] = w_new
            if np.all(delta < self.TOL * (1.0 + np.abs(w_new))):
                break
        rdot = np.einsum("nij,nj->ni", T, w)
        return w, rdot

    def _eval_poly(self, t, order: int):
        idx = np.clip(np.searchsorted(self.times, t, side="right") - 1, 0,
                      len(self.times) - 2)
        tau = (t - self.times[idx])[:, None]
        c3, c2, c1 = self._c3[idx], self._c2[idx], self._c1[idx]
        if order == 0:
            return idx, ((c3 * tau + c2) * tau + c1) * tau
        if order == 1:
            return idx, (3.0 * c3 * tau + 2.0 * c2) * tau + c1
        return idx, 6.0 * c3 * tau + 2.0 * c2

    def __call__(self, t, order: int = 0):
        if order not in (0, 1, 2):
            raise ValueError("order must be 0, 1 or 2")
        t = np.asarray(t, dtype=np.float64)
        single = t.ndim == 0
        t = np.atleast_1d(t)
        idx, r = self._eval_poly(t, 0)
        if order == 0:
            out = self.rotations[idx] * Rotation.from_rotvec(r)
            return out[0] if single else out
        _, rdot = self._eval_poly(t, 1)
        if order == 1:
            res = np.einsum("nij,nj->ni", _rotvec_dot_to_rate(r), rdot)
        else:
            _, rddot = self._eval_poly(t, 2)
            res = (np.einsum("nij,nj->ni", _rotvec_dot_to_rate(r), rddot)
                   + _accel_quadratic_term(r, rdot))
        return res[0] if single else res


# ---------------------------------------------------------------------------
# 3-D rotation groups (the spatial/transform/_rotation_groups.py surface).
#
# Instead of literal quaternion tables, the polyhedral groups are built by
# CLOSURE from generators: start from the generator set and multiply until
# no new element appears (canonicalizing q ~ -q). The closure guarantees
# group correctness by construction; tests additionally pin set-equality
# against scipy's create_group.
# ---------------------------------------------------------------------------


def _canonical_quats(quats: np.ndarray) -> np.ndarray:
    """Dedup + canonicalize (q ~ -q) + lexicographic sort of [n,4] quats."""
    q = _normalize(np.asarray(quats, dtype=np.float64))
    # flip so the first nonzero component (scanning w,z,y,x) is positive
    key = np.where(np.abs(q) > 1e-9, np.sign(q), 0.0)
    lead = np.argmax(np.abs(key[:, ::-1]) > 0, axis=1)
    flip = key[np.arange(len(q)), 3 - lead] < 0
    q[flip] *= -1.0
    q = np.round(q / 1e-12) * 1e-12  # stable dedup at closure tolerance
    order = np.lexsort(q.T)
    q = q[order]
    keep = np.ones(len(q), bool)
    keep[1:] = np.any(np.abs(np.diff(q, axis=0)) > 1e-9, axis=1)
    return q[keep]


def _closure(generators: np.ndarray, max_order: int = 120) -> np.ndarray:
    elems = _canonical_quats(np.vstack([generators, [[0.0, 0.0, 0.0, 1.0]]]))
    while True:
        prod = _quat_mul(elems[:, None, :], elems[None, :, :]).reshape(-1, 4)
        new = _canonical_quats(np.vstack([elems, prod]))
        if len(new) == len(elems):
            return new
        elems = new
        if len(elems) > max_order:
            # a float-noisy/pathological generator set would otherwise grow
            # forever; raise (not assert — python -O strips asserts)
            raise ValueError(
                f"group closure diverged past {max_order} elements; "
                "generators do not generate a finite rotation group"
            )


def _axis_rotvec(axis: int, angle: float) -> np.ndarray:
    rv = np.zeros(3)
    rv[axis] = angle
    return rv


def create_group(cls, group: str, axis: str = "Z") -> "Rotation":
    """Rotation.create_group work-alike: 'I', 'O', 'T', 'Cn', 'Dn'."""
    if not isinstance(group, str):
        raise ValueError("group must be a string")
    if axis not in "xyzXYZ" or len(axis) != 1:
        raise ValueError("axis must be one of x, y, z, X, Y, Z")
    ax = "xyz".index(axis.lower())

    if group in ("I", "O", "T"):
        third = Rotation.from_rotvec(
            np.full(3, 2.0 * np.pi / 3.0 / np.sqrt(3.0))).as_quat()
        half_z = Rotation.from_rotvec([0.0, 0.0, np.pi]).as_quat()
        gens = [third, half_z]
        if group == "O":
            gens.append(Rotation.from_rotvec([0.0, 0.0, np.pi / 2.0]).as_quat())
        if group == "I":
            # a 5-fold axis of the icosahedron through vertex (0, 1, phi)
            phi = (1.0 + np.sqrt(5.0)) / 2.0
            v = np.array([0.0, 1.0, phi]) / np.sqrt(1.0 + phi * phi)
            gens.append(Rotation.from_rotvec(v * 2.0 * np.pi / 5.0).as_quat())
        return cls.from_quat(_closure(np.vstack(gens)))

    if group[:1] in ("C", "D") and group[1:].isdigit():
        n = int(group[1:])
        if n < 1:
            raise ValueError("group order must be positive")
        thetas = 2.0 * np.pi * np.arange(n) / n
        rv = [_axis_rotvec(ax, t) for t in thetas]
        if group[0] == "D":
            # n two-fold axes in the plane normal to the cyclic axis
            half = np.pi * np.arange(n) / n
            for t in half:
                r = np.zeros(3)
                r[(ax + 1) % 3] = np.pi * np.cos(t)
                r[(ax + 2) % 3] = np.pi * np.sin(t)
                rv.append(r)
        return cls.from_rotvec(np.asarray(rv))

    raise ValueError("group must be one of 'I', 'O', 'T', 'Dn', 'Cn'")


Rotation.create_group = classmethod(create_group)
