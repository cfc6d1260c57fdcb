"""Exact planar MuJoCo dynamics as batched torch ops: the physics of the
on-device locomotion loop (HalfCheetah, Hopper, Walker2d).

Counterpart of the JAX package's envs/planar_physics.py: PlanarModel :54,
extract_planar_model :116-316 and PlanarPhysics :324-752 (``_poses`` :359,
``_coms_and_angles`` :405, ``contact_points`` :419, ``_contact_kinematics``
:423, ``mass_matrix`` :445, ``_potential`` :459, ``bias_forces`` :464,
``_actuation`` :480, ``_impedance`` :493, ``_kb`` :512,
``_constraint_rows`` :521, ``_forward`` :616, ``step`` :696,
``_step_euler`` :702, ``_step_rk4`` :720, ``env_step`` :743). The module
keeps its counterpart's name so that a reader finds it.

* **The model** comes from the real mjModel, extracted on the host by
  :func:`extract_planar_model` (which imports gymnasium and mujoco inside the
  function) and committed as ``planar_models/<env>[_search].npz``, so that a
  machine without mujoco loads it with :func:`load_planar_model`. Regenerate
  the files with ``python -m dadiff_tpu_torch.envs.planar_physics --export``.
  Each file also holds what a gymnasium reset draws from: ``init_qpos``,
  ``init_qvel``, the reset noise scale and whether qvel's noise is normal.
* **Smooth dynamics** are written out for the planar tree instead of taken
  by autodiff: one walk down the tree gives every dof's world twist (a slide
  moves a point along its axis, a hinge turns it about its anchor) and that
  twist's time derivative, so a point's Jacobian is ``lin + ang * perp(P)``
  and its velocity-product acceleration ``sum_d v_d (lin_dot + ang *
  perp(P_dot))``. Then M = sum m Jc^T Jc + I Jth^T Jth + armature, and the
  bias c = sum m Jc^T (Jc_dot v - g), which equals the JAX package's Mdot v
  - d(v^T M v / 2)/dq + dV/dq (the planar body has no gyroscopic term).
* **Constraints and solvers** as the JAX package: MuJoCo's soft contacts and
  joint limits, a pyramidal cone, and a fixed number of PGS sweeps
  (sequential over rows) or of diagonally preconditioned FISTA ("jacobi":
  one masked product per iteration). The trip counts are fixed, the
  Cholesky factorizations take ``cholesky_ex`` (no check of ``info``) and
  the solves two triangular solves, so a step makes no host sync and
  allocates nothing outside PyTorch's pool: it can be captured in a CUDA
  graph.

Every function takes (B, nv) tensors on one device, in float64 or float32
as the caller chooses, and keeps that dtype.
"""

from __future__ import annotations

import argparse
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

SLIDE_X, SLIDE_Z, HINGE_Y = 0, 1, 2

MODEL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "planar_models")

# the contact sets of the cheaper search models (locomotion_jax.py :130-160)
SEARCH_GEOMS = {
    "HalfCheetah-v5": ("bthigh", "bshin", "bfoot", "fthigh", "fshin",
                       "ffoot"),
    "Hopper-v5": ("foot_geom", "leg_geom"),
    "Walker2d-v5": ("foot_geom", "leg_geom", "foot_left_geom",
                    "leg_left_geom"),
}
# gymnasium's reset_model: HalfCheetah draws qvel normal, the others uniform
NORMAL_QVEL_NOISE = ("HalfCheetah-v5",)


class PlanarModel(NamedTuple):
    """Static planar rigid-body model (planar_physics.py:54-104), with what a
    gymnasium reset needs. Bodies are 1..nb (0 = world); arrays drop the
    world row. Geometry lies in the xz-plane; rotations are about +y."""

    parent: np.ndarray        # (nb,) parent body index (0-based incl. world)
    body_pos: np.ndarray      # (nb, 2) body frame offset in parent frame
    dof_body: np.ndarray      # (nv,) body each dof belongs to (1-based)
    dof_type: np.ndarray      # (nv,) SLIDE_X / SLIDE_Z / HINGE_Y
    dof_anchor: np.ndarray    # (nv, 2) hinge anchor in body frame
    dof_sign: np.ndarray      # (nv,) +1/-1: joint axis sign
    dof_ref: np.ndarray       # (nv,) joint reference (qpos0)
    mass: np.ndarray          # (nb,)
    inertia_y: np.ndarray     # (nb,) rotational inertia about +y through COM
    ipos: np.ndarray          # (nb, 2) COM offset in body frame
    armature: np.ndarray      # (nv,)
    damping: np.ndarray       # (nv,)
    stiffness: np.ndarray     # (nv,)
    springref: np.ndarray     # (nv,)
    jnt_limited: np.ndarray   # (nv,) bool
    jnt_range: np.ndarray     # (nv, 2)
    limit_solref: np.ndarray  # (nv, 2)
    limit_solimp: np.ndarray  # (nv, 5)
    act_dof: np.ndarray       # (nu,) dof driven by each actuator
    gear: np.ndarray          # (nu,)
    ctrl_range: np.ndarray    # (nu, 2)
    con_body: np.ndarray      # (nc,) body of each contact sphere (1-based)
    con_pos: np.ndarray       # (nc, 2) sphere center in body frame
    con_radius: np.ndarray    # (nc,)
    con_friction: np.ndarray  # (nc,)
    con_solref: np.ndarray    # (nc, 2)
    con_solimp: np.ndarray    # (nc, 5)
    con_invweight: np.ndarray  # (nc,) body_invweight0 trans sum of the pair
    con_margin: np.ndarray    # (nc,) includemargin
    dof_invweight: np.ndarray  # (nv,) dof_invweight0 (limit rows)
    impratio: float
    timestep: float
    gravity: float            # signed z acceleration (-9.81)
    integrator: str           # 'euler' (implicit damping) or 'rk4'
    nv: int
    nu: int
    nb: int
    # a gymnasium reset: init + U(-scale, scale) for qpos, and for qvel the
    # same or scale * N(0, 1) where reset_qvel_normal
    init_qpos: np.ndarray     # (nv,)
    init_qvel: np.ndarray     # (nv,)
    reset_noise_scale: float
    reset_qvel_normal: bool


SCALAR_FIELDS = ("impratio", "timestep", "gravity", "integrator", "nv", "nu",
                 "nb", "reset_noise_scale", "reset_qvel_normal")


def _quat_rot(quat: np.ndarray) -> np.ndarray:
    w, x, y, z = quat
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def extract_planar_model(
    env_name: str,
    contact_geoms: Optional[Tuple[str, ...]] = None,
) -> PlanarModel:
    """Build a PlanarModel from the real gymnasium/MuJoCo model, host-only
    (planar_physics.py:116-316). Raises unless the model is planar.

    ``contact_geoms``: optional geom-name whitelist for the contact candidate
    set (the cheaper search model); default every colliding geom (the exact
    model)."""
    import gymnasium as gym
    import mujoco

    env = gym.make(env_name)
    m = env.unwrapped.model
    init_qpos = np.asarray(env.unwrapped.init_qpos, np.float64).copy()
    init_qvel = np.asarray(env.unwrapped.init_qvel, np.float64).copy()
    noise_scale = float(env.unwrapped._reset_noise_scale)
    env.close()

    nv, nu, nb = int(m.nv), int(m.nu), int(m.nbody) - 1
    if int(m.nq) != nv:
        raise ValueError(f"{env_name}: nq != nv — not a planar slide/hinge tree")

    dof_type = np.zeros(nv, np.int32)
    dof_body = np.zeros(nv, np.int32)
    dof_anchor = np.zeros((nv, 2), np.float64)
    dof_sign = np.ones(nv, np.float64)
    dof_ref = np.zeros(nv, np.float64)
    for j in range(m.njnt):
        jtype, axis = int(m.jnt_type[j]), m.jnt_axis[j]
        dof = int(m.jnt_dofadr[j])
        dof_body[dof] = int(m.jnt_bodyid[j])
        dof_anchor[dof] = m.jnt_pos[j][[0, 2]]
        dof_ref[dof] = m.qpos0[int(m.jnt_qposadr[j])]
        if jtype == mujoco.mjtJoint.mjJNT_SLIDE and abs(axis[0]) > 0.99:
            dof_type[dof] = SLIDE_X
            dof_sign[dof] = np.sign(axis[0])
        elif jtype == mujoco.mjtJoint.mjJNT_SLIDE and abs(axis[2]) > 0.99:
            dof_type[dof] = SLIDE_Z
            dof_sign[dof] = np.sign(axis[2])
        elif jtype == mujoco.mjtJoint.mjJNT_HINGE and abs(axis[1]) > 0.99:
            dof_type[dof] = HINGE_Y
            dof_sign[dof] = np.sign(axis[1])
        else:
            raise ValueError(f"{env_name}: joint {j} is not planar")

    body_pos = np.zeros((nb, 2))
    mass = np.zeros(nb)
    inertia_y = np.zeros(nb)
    ipos = np.zeros((nb, 2))
    parent = np.zeros(nb, np.int32)
    for b in range(1, m.nbody):
        if np.abs(m.body_quat[b] - np.array([1, 0, 0, 0])).max() > 1e-12:
            raise ValueError(f"{env_name}: body {b} has a fixed rotation "
                             "(unsupported in the planar extractor)")
        parent[b - 1] = int(m.body_parentid[b])
        body_pos[b - 1] = m.body_pos[b][[0, 2]]
        mass[b - 1] = m.body_mass[b]
        ipos[b - 1] = m.body_ipos[b][[0, 2]]
        # Iyy about the COM: the principal inertia rotated into the body
        # frame, its (y, y) entry (invariant under planar motion)
        R = _quat_rot(m.body_iquat[b])
        I_world = R @ np.diag(m.body_inertia[b]) @ R.T
        inertia_y[b - 1] = I_world[1, 1]

    act_dof = np.zeros(nu, np.int32)
    gear = np.zeros(nu)
    for u in range(nu):
        jid = int(m.actuator_trnid[u][0])
        act_dof[u] = int(m.jnt_dofadr[jid])
        gear[u] = m.actuator_gear[u][0]

    # contact candidates: both end-spheres of every capsule that can collide
    # with the floor plane (a sphere geom gives one)
    con_body, con_pos, con_radius = [], [], []
    con_friction, con_solref, con_solimp = [], [], []
    con_invweight, con_margin = [], []
    floor = None
    for g in range(m.ngeom):
        if int(m.geom_type[g]) == mujoco.mjtGeom.mjGEOM_PLANE:
            floor = g
    for g in range(m.ngeom):
        gtype = int(m.geom_type[g])
        b = int(m.geom_bodyid[g])
        if b == 0 or floor is None:
            continue
        if contact_geoms is not None:
            gname = mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_GEOM, g)
            if gname not in contact_geoms:
                continue
        can_collide = (m.geom_contype[g] & m.geom_conaffinity[floor]) or \
                      (m.geom_contype[floor] & m.geom_conaffinity[g])
        if not can_collide:
            continue
        # the pair's parameters as MuJoCo mixes them (mj_contactParam):
        # friction = max; unequal priority takes the higher geom's; equal
        # priority the solmix-weighted mean of solimp and of positive solref,
        # the elementwise min of direct solref
        p_g, p_f = int(m.geom_priority[g]), int(m.geom_priority[floor])
        if p_g != p_f:
            hi = g if p_g > p_f else floor
            fric = m.geom_friction[hi][0]
            solref = np.array(m.geom_solref[hi], dtype=np.float64)
            solimp = np.array(m.geom_solimp[hi], dtype=np.float64)
        else:
            fric = max(m.geom_friction[g][0], m.geom_friction[floor][0])
            s1 = float(m.geom_solmix[g])
            s2 = float(m.geom_solmix[floor])
            if s1 >= mujoco.mjMINVAL and s2 >= mujoco.mjMINVAL:
                mix = s1 / (s1 + s2)
            elif s1 < mujoco.mjMINVAL and s2 < mujoco.mjMINVAL:
                mix = 0.5
            else:
                mix = 0.0 if s1 < mujoco.mjMINVAL else 1.0
            if m.geom_solref[g][0] > 0 and m.geom_solref[floor][0] > 0:
                solref = mix * m.geom_solref[g] \
                    + (1.0 - mix) * m.geom_solref[floor]
            else:
                solref = np.minimum(m.geom_solref[g], m.geom_solref[floor])
            solimp = mix * m.geom_solimp[g] \
                + (1.0 - mix) * m.geom_solimp[floor]
        R = _quat_rot(m.geom_quat[g])
        center = m.geom_pos[g][[0, 2]]
        if gtype == mujoco.mjtGeom.mjGEOM_CAPSULE:
            half = m.geom_size[g][1]
            axis = (R @ np.array([0.0, 0.0, 1.0]))[[0, 2]]
            ends = [center + half * axis, center - half * axis]
        elif gtype == mujoco.mjtGeom.mjGEOM_SPHERE:
            ends = [center]
        else:
            continue
        invw = (m.body_invweight0[b][0]
                + m.body_invweight0[m.geom_bodyid[floor]][0])
        # includemargin = (margin1 + margin2) - (gap1 + gap2)
        incmargin = (m.geom_margin[g] + m.geom_margin[floor]
                     - m.geom_gap[g] - m.geom_gap[floor])
        for e in ends:
            con_body.append(b)
            con_pos.append(e)
            con_radius.append(m.geom_size[g][0])
            con_friction.append(fric)
            con_solref.append(solref)
            con_solimp.append(solimp)
            con_invweight.append(invw)
            con_margin.append(incmargin)

    integ = {0: "euler", 1: "rk4"}.get(int(m.opt.integrator))
    if integ is None:
        raise ValueError(f"{env_name}: unsupported integrator "
                         f"{int(m.opt.integrator)}")

    return PlanarModel(
        parent=parent,
        body_pos=body_pos,
        dof_body=dof_body,
        dof_type=dof_type,
        dof_anchor=dof_anchor,
        dof_sign=dof_sign,
        dof_ref=dof_ref,
        mass=mass,
        inertia_y=inertia_y,
        ipos=ipos,
        armature=np.asarray(m.dof_armature, np.float64).copy(),
        damping=np.asarray(m.dof_damping, np.float64).copy(),
        stiffness=np.array([m.jnt_stiffness[m.dof_jntid[d]] for d in range(nv)]),
        springref=np.array([m.qpos_spring[m.jnt_qposadr[m.dof_jntid[d]]]
                            for d in range(nv)]),
        jnt_limited=np.array([bool(m.jnt_limited[m.dof_jntid[d]])
                              for d in range(nv)]),
        jnt_range=np.array([m.jnt_range[m.dof_jntid[d]] for d in range(nv)]),
        limit_solref=np.array([m.jnt_solref[m.dof_jntid[d]] for d in range(nv)]),
        limit_solimp=np.array([m.jnt_solimp[m.dof_jntid[d]] for d in range(nv)]),
        act_dof=act_dof,
        gear=gear,
        ctrl_range=np.asarray(m.actuator_ctrlrange, np.float64).copy(),
        con_body=np.asarray(con_body, np.int32),
        con_pos=np.asarray(con_pos, np.float64),
        con_radius=np.asarray(con_radius, np.float64),
        con_friction=np.asarray(con_friction, np.float64),
        con_solref=np.asarray(con_solref, np.float64),
        con_solimp=np.asarray(con_solimp, np.float64),
        con_invweight=np.asarray(con_invweight, np.float64),
        con_margin=np.asarray(con_margin, np.float64),
        dof_invweight=np.asarray(m.dof_invweight0, np.float64).copy(),
        impratio=float(m.opt.impratio),
        integrator=integ,
        timestep=float(m.opt.timestep),
        gravity=float(m.opt.gravity[2]),
        nv=nv, nu=nu, nb=nb,
        init_qpos=init_qpos,
        init_qvel=init_qvel,
        reset_noise_scale=noise_scale,
        reset_qvel_normal=env_name in NORMAL_QVEL_NOISE,
    )


def model_path(env_name: str, search: bool = False) -> str:
    return os.path.join(MODEL_DIR, f"{env_name}{'_search' if search else ''}"
                        ".npz")


def save_planar_model(model: PlanarModel, path: str) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in model._asdict().items()})


def load_planar_model(env_name: str, search: bool = False) -> PlanarModel:
    """The committed model of ``env_name`` (the exact one, or with ``search``
    the restricted contact set of :data:`SEARCH_GEOMS`); never imports
    mujoco."""
    path = model_path(env_name, search)
    if not os.path.exists(path):
        raise ValueError(f"no planar model of {env_name!r} at {path}")
    with np.load(path) as f:
        fields = {}
        for k in PlanarModel._fields:
            v = f[k]
            fields[k] = v.item() if k in SCALAR_FIELDS else v.copy()
    fields["integrator"] = str(fields["integrator"])
    fields["reset_qvel_normal"] = bool(fields["reset_qvel_normal"])
    for k in ("nv", "nu", "nb"):
        fields[k] = int(fields[k])
    return PlanarModel(**fields)


# ---------------------------------------------------------------------------
# Dynamics
# ---------------------------------------------------------------------------


def _rot(c, s, u):
    """R(th) u for u (..., 2) or a constant pair: [c u0 + s u1, -s u0 + c u1]."""
    return torch.stack([c * u[..., 0] + s * u[..., 1],
                        -s * u[..., 0] + c * u[..., 1]], dim=-1)


def _chol_solve(L, b):
    """Solve (L L^T) x = b for a batch of lower Cholesky factors by two
    triangular solves (cuBLAS trsm on the card): ``cholesky_solve`` takes
    MAGMA for a batch there, which allocates device memory per call and so
    breaks CUDA-graph capture."""
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def _perp(w):
    """dR(th)u/dth = perp(R(th) u), perp(w) = [w_z, -w_x]."""
    return torch.stack([w[..., 1], -w[..., 0]], dim=-1)


class _Consts(NamedTuple):
    """The model's arrays as tensors of one device and dtype."""

    body_pos: torch.Tensor
    dof_anchor: torch.Tensor
    mass: torch.Tensor
    inertia_y: torch.Tensor
    ipos: torch.Tensor
    armature: torch.Tensor
    damping: torch.Tensor
    stiffness: torch.Tensor
    springref: torch.Tensor
    ctrl_lo: torch.Tensor
    ctrl_hi: torch.Tensor
    act_dof: torch.Tensor
    gear: torch.Tensor
    body_anc: torch.Tensor     # (nb, nv) 1 where dof d moves body b
    ang: torch.Tensor          # (nv,) a dof's angular rate: sign at hinges
    con_body: torch.Tensor     # (nc,) 0-based body index
    con_pos: torch.Tensor
    con_radius: torch.Tensor
    con_margin: torch.Tensor
    con_solimp: torch.Tensor
    con_solref: torch.Tensor
    con_friction: torch.Tensor
    con_R_scale: torch.Tensor  # invweight * 2 mu^2 (1 + mu^2) / impratio
    lim_dofs: torch.Tensor
    lim_lo: torch.Tensor
    lim_hi: torch.Tensor
    lim_solref: torch.Tensor
    lim_solimp: torch.Tensor
    lim_invw: torch.Tensor
    lim_J: torch.Tensor        # (2 nl, nv): +e rows (q > lo), then -e rows


class PlanarPhysics:
    """Batched planar dynamics with MuJoCo semantics (planar_physics.py:
    324-752). ``step(qpos, qvel, ctrl)`` advances (B, nv) states one MuJoCo
    timestep; ``env_step`` composes ``frame_skip`` of them.

    ``solver``: 'pgs' (Gauss-Seidel sweeps, sequential over rows; the
    reference) or 'jacobi' (preconditioned FISTA, one masked product per
    iteration; for wide batches and long loops on the card).
    ``pyramid_edges``: 4 (MuJoCo-exact) or 2 (the search model drops the
    degenerate y-tangent edges)."""

    def __init__(self, model: PlanarModel, solver_iters: int = 30,
                 solver: str = "pgs", pyramid_edges: int = 4):
        if solver not in ("pgs", "jacobi"):
            raise ValueError(f"unknown solver {solver!r}")
        if pyramid_edges not in (2, 4):
            raise ValueError("pyramid_edges must be 2 (cheap search model "
                             "— drops the degenerate y-tangent rows) or 4 "
                             "(MuJoCo-exact)")
        self.m = model
        self.solver_iters = solver_iters
        self.solver = solver
        self.pyramid_edges = pyramid_edges
        self._body_dofs = [
            [d for d in range(model.nv) if model.dof_body[d] == b + 1]
            for b in range(model.nb)
        ]
        # dof d moves body b when d belongs to b or to one of its ancestors
        anc = np.zeros((model.nb, model.nv))
        for b in range(model.nb):
            pb = int(model.parent[b])
            if pb:
                anc[b] = anc[pb - 1]
            anc[b, self._body_dofs[b]] = 1.0
        self._anc = anc
        self._lim_dofs = [d for d in range(model.nv) if model.jnt_limited[d]]
        self._consts = {}

    @property
    def n_rows(self) -> int:
        """Constraint rows: pyramid edges of every contact, then two limit
        rows per limited dof."""
        return (self.pyramid_edges * len(self.m.con_body)
                + 2 * len(self._lim_dofs))

    def consts(self, device, dtype) -> _Consts:
        """The model's tensors on ``device`` in ``dtype``, built once (a
        captured step then copies nothing from the host)."""
        key = (torch.device(device), dtype)
        c = self._consts.get(key)
        if c is not None:
            return c
        m = self.m

        def t(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

        mu = np.asarray(m.con_friction, np.float64)
        lim = self._lim_dofs
        nl = len(lim)
        lim_J = np.zeros((2 * nl, m.nv))
        lim_J[np.arange(nl), lim] = 1.0
        lim_J[nl + np.arange(nl), lim] = -1.0
        c = _Consts(
            body_pos=t(m.body_pos), dof_anchor=t(m.dof_anchor),
            mass=t(m.mass), inertia_y=t(m.inertia_y), ipos=t(m.ipos),
            armature=t(m.armature), damping=t(m.damping),
            stiffness=t(m.stiffness), springref=t(m.springref),
            ctrl_lo=t(m.ctrl_range[:, 0]), ctrl_hi=t(m.ctrl_range[:, 1]),
            act_dof=t(m.act_dof, torch.long), gear=t(m.gear),
            body_anc=t(self._anc),
            ang=t(np.where(m.dof_type == HINGE_Y, m.dof_sign, 0.0)),
            con_body=t(np.asarray(m.con_body) - 1, torch.long),
            con_pos=t(m.con_pos).reshape(-1, 2),
            con_radius=t(m.con_radius), con_margin=t(m.con_margin),
            con_solimp=t(m.con_solimp).reshape(-1, 5),
            con_solref=t(m.con_solref).reshape(-1, 2),
            con_friction=t(mu),
            con_R_scale=t(np.asarray(m.con_invweight) * 2.0 * mu * mu
                          * (1.0 + mu * mu) / m.impratio),
            lim_dofs=t(lim, torch.long),
            lim_lo=t(np.asarray(m.jnt_range)[lim, 0]),
            lim_hi=t(np.asarray(m.jnt_range)[lim, 1]),
            lim_solref=t(np.asarray(m.limit_solref)[lim]).reshape(-1, 2),
            lim_solimp=t(np.asarray(m.limit_solimp)[lim]).reshape(-1, 5),
            lim_invw=t(np.asarray(m.dof_invweight)[lim]),
            lim_J=t(lim_J),
        )
        self._consts[key] = c
        return c

    # -- kinematics ------------------------------------------------------

    def _walk(self, qpos, qvel=None):
        """One walk down the tree (planar_physics.py:359-403): each body's
        world origin, angle (and with ``qvel`` the origin's velocity and the
        angular rate), and each dof's world twist: ``lin`` (B, nv, 2), so
        that dP/dq_d = lin_d + ang_d perp(P) for a point P the dof moves,
        and with ``qvel`` its time derivative ``lin_dot``."""
        m = self.m
        c = self.consts(qpos.device, qpos.dtype)
        B = qpos.shape[0]
        zero = qpos.new_zeros(B)
        poses = [None] * m.nb
        lin = [None] * m.nv
        lin_dot = [None] * m.nv
        with_vel = qvel is not None
        for b in range(m.nb):
            pb = int(m.parent[b])
            off = c.body_pos[b]
            if pb == 0:
                pos = off.expand(B, 2)
                th = zero
                vpos, om = ((qpos.new_zeros(B, 2), zero) if with_vel
                            else (None, None))
            else:
                ppos, th, pv, om = poses[pb - 1]
                co, si = torch.cos(th), torch.sin(th)
                r = _rot(co, si, off)
                pos = ppos + r
                vpos = pv + om[:, None] * _perp(r) if with_vel else None
            for d in self._body_dofs[b]:
                sign = float(m.dof_sign[d])
                q = (qpos[:, d] - float(m.dof_ref[d])) * sign
                t = int(m.dof_type[d])
                co, si = torch.cos(th), torch.sin(th)
                if t != HINGE_Y:
                    # the slide's world axis at the frame's current angle
                    axis = (torch.stack([co, -si], -1) if t == SLIDE_X
                            else torch.stack([si, co], -1))
                    lin[d] = sign * axis
                    pos = pos + axis * q[:, None]
                    if with_vel:
                        turn = om[:, None] * _perp(axis)
                        lin_dot[d] = sign * turn
                        vpos = vpos + turn * q[:, None] \
                            + axis * (sign * qvel[:, d])[:, None]
                else:
                    # rotate the frame about the anchor
                    a = _rot(co, si, c.dof_anchor[d])
                    aw = pos + a
                    lin[d] = -sign * _perp(aw)
                    th = th + q
                    co2, si2 = torch.cos(th), torch.sin(th)
                    a2 = _rot(co2, si2, c.dof_anchor[d])
                    pos = aw - a2
                    if with_vel:
                        vaw = vpos + om[:, None] * _perp(a)
                        lin_dot[d] = -sign * _perp(vaw)
                        om = om + sign * qvel[:, d]
                        vpos = vaw - om[:, None] * _perp(a2)
            poses[b] = (pos, th, vpos, om)
        lin = torch.stack(lin, dim=1)
        lin_dot = torch.stack(lin_dot, dim=1) if with_vel else None
        return poses, lin, lin_dot

    def _points(self, poses, body, local, with_vel):
        """World position (B, n, 2) of points fixed at ``local`` (n, 2) in
        bodies ``body`` (python list), their bodies' angles (B, n), and with
        ``with_vel`` their velocities."""
        pos = torch.stack([poses[b][0] for b in body], dim=1)
        th = torch.stack([poses[b][1] for b in body], dim=1)
        co, si = torch.cos(th), torch.sin(th)
        r = _rot(co, si, local)
        p = pos + r
        if not with_vel:
            return p, th, None
        vpos = torch.stack([poses[b][2] for b in body], dim=1)
        om = torch.stack([poses[b][3] for b in body], dim=1)
        return p, th, vpos + om[..., None] * _perp(r)

    def _jacobian(self, c, lin, body_idx, p):
        """dP/dq (B, n, 2, nv) of points ``p`` (B, n, 2) on bodies
        ``body_idx`` (n,) long."""
        anc = c.body_anc[body_idx]                      # (n, nv)
        J = lin.transpose(1, 2)[:, None] \
            + c.ang[None, None, None, :] * _perp(p)[..., None]
        return J * anc[None, :, None, :]

    def _coms_and_angles(self, qpos):
        """World COM of every body (B, nb, 2) and its angle (B, nb)."""
        c = self.consts(qpos.device, qpos.dtype)
        poses, _, _ = self._walk(qpos)
        p, th, _ = self._points(poses, range(self.m.nb), c.ipos, False)
        return p, th

    def contact_points(self, qpos):
        """World (x, z) of every candidate contact sphere center, (B, nc, 2)."""
        return self._contact_kinematics(qpos)[0]

    def _contact_kinematics(self, qpos):
        """(centers (B, nc, 2), the contact bodies' angles (B, nc))."""
        c = self.consts(qpos.device, qpos.dtype)
        poses, _, _ = self._walk(qpos)
        body = [int(b) - 1 for b in self.m.con_body]
        p, th, _ = self._points(poses, body, c.con_pos, False)
        return p, th

    # -- smooth dynamics -------------------------------------------------

    def _smooth(self, qpos, qvel):
        """(M (B, nv, nv), bias c (B, nv), the walk's poses and twists)."""
        m = self.m
        c = self.consts(qpos.device, qpos.dtype)
        poses, lin, lin_dot = self._walk(qpos, qvel)
        bodies = torch.arange(m.nb, device=qpos.device)
        com, _, vcom = self._points(poses, range(m.nb), c.ipos, True)
        Jc = self._jacobian(c, lin, bodies, com)        # (B, nb, 2, nv)
        Jth = c.body_anc * c.ang                        # (nb, nv)
        M = (torch.einsum("b,Bbiv,Bbiw->Bvw", c.mass, Jc, Jc)
             + torch.einsum("b,bv,bw->vw", c.inertia_y, Jth, Jth)
             + torch.diag(c.armature))
        # the COM's acceleration at zero qacc: Jc_dot v
        rate = lin_dot.transpose(1, 2)[:, None] \
            + c.ang[None, None, None, :] * _perp(vcom)[..., None]
        acc = torch.einsum("Bbiv,Bv->Bbi",
                           rate * c.body_anc[None, :, None, :], qvel)
        acc = torch.stack([acc[..., 0], acc[..., 1] - m.gravity], dim=-1)
        bias = torch.einsum("b,Bbiv,Bbi->Bv", c.mass, Jc, acc)
        return M, bias, poses, lin

    def mass_matrix(self, qpos):
        """Joint-space inertia (B, nv, nv) (planar_physics.py:445-457)."""
        return self._smooth(qpos, torch.zeros_like(qpos))[0]

    def _potential(self, qpos):
        """Gravity's potential (B,) (planar_physics.py:459-462)."""
        coms, _ = self._coms_and_angles(qpos)
        mass = self.consts(qpos.device, qpos.dtype).mass
        return -self.m.gravity * (mass * coms[..., 1]).sum(-1)

    def bias_forces(self, qpos, qvel):
        """Coriolis, centrifugal and gravity forces c (B, nv) with
        M qacc + c = tau (planar_physics.py:464-478)."""
        return self._smooth(qpos, qvel)[1]

    def _actuation(self, ctrl, dtype):
        c = self.consts(ctrl.device, dtype)
        u = torch.clamp(ctrl.to(dtype), c.ctrl_lo, c.ctrl_hi)
        tau = u.new_zeros(u.shape[0], self.m.nv)
        return tau.index_add(1, c.act_dof, c.gear * u)

    # -- constraints -----------------------------------------------------

    @staticmethod
    def _impedance(solimp, violation):
        """MuJoCo's position-dependent impedance d(r), its endpoints clamped
        to [1e-4, 0.9999] (planar_physics.py:493-509)."""
        d0, dw, width, mid, power = (solimp[..., 0], solimp[..., 1],
                                     solimp[..., 2], solimp[..., 3],
                                     solimp[..., 4])
        d0 = torch.clamp(d0, 1e-4, 0.9999)
        dw = torch.clamp(dw, 1e-4, 0.9999)
        x = torch.clamp(violation.abs() / torch.clamp(width, min=1e-12),
                        0.0, 1.0)
        lo = (x / torch.clamp(mid, min=1e-12)) ** power * mid
        hi = 1.0 - ((1.0 - x) / torch.clamp(1.0 - mid, min=1e-12)) ** power \
            * (1.0 - mid)
        y = torch.where(x < mid, lo, hi)
        return d0 + y * (dw - d0)

    @staticmethod
    def _kb(solref, solimp_d):
        """Stiffness and damping of the reference acceleration from solref
        (planar_physics.py:512-519)."""
        tc, zeta = solref[..., 0], solref[..., 1]
        dmax = torch.clamp(solimp_d, min=1e-8)
        tcc = torch.clamp(tc, min=1e-8)
        b = 2.0 / (dmax * tcc)
        k = 1.0 / (dmax * dmax * tcc ** 2 * torch.clamp(zeta, min=1e-8) ** 2)
        return k, b

    def _constraint_rows(self, qpos, qvel, poses=None, lin=None):
        """Soft-constraint rows of fixed shape, inactive ones masked
        (planar_physics.py:521-612): (J (B, nr, nv), aref (B, nr), R (B, nr),
        active (B, nr) bool), or None where the model has none. Rows: the
        pyramid edges n + mu t, n - mu t (and the two degenerate y-tangent
        edges, pure normal rows, with 4 edges), each over every contact,
        then the lower and the upper limit rows."""
        m = self.m
        c = self.consts(qpos.device, qpos.dtype)
        rows_J, rows_aref, rows_R, rows_active = [], [], [], []
        nc = len(m.con_body)
        if nc:
            if poses is None:
                poses, lin, _ = self._walk(qpos)
            body = [int(b) - 1 for b in m.con_body]
            pts, _, _ = self._points(poses, body, c.con_pos, False)
            Jp = self._jacobian(c, lin, c.con_body, pts)   # (B, nc, 2, nv)
            Jang = c.body_anc[c.con_body] * c.ang          # (nc, nv)
            geom_dist = pts[..., 1] - c.con_radius
            dist = geom_dist - c.con_margin
            viol = torch.clamp(-dist, min=0.0)
            d_imp = self._impedance(c.con_solimp, viol)
            k, b = self._kb(c.con_solref, c.con_solimp[:, 1])
            active = dist < 0.0
            mu = c.con_friction
            d_eff = torch.clamp(d_imp, 1e-6, 1.0 - 1e-6)
            R_con = (1.0 - d_eff) / d_eff * c.con_R_scale
            Jn = Jp[:, :, 1, :]
            # the contact point sits midway through the penetration: its
            # offset below the sphere center feeds the tangent's w x r term
            r_off = c.con_radius + torch.clamp(geom_dist, max=0.0) / 2.0
            Jt = Jp[:, :, 0, :] - r_off[..., None] * Jang
            edges = [Jn + mu[:, None] * Jt, Jn - mu[:, None] * Jt]
            if self.pyramid_edges == 4:
                edges += [Jn, Jn]
            for Je in edges:
                ve = (Je * qvel[:, None, :]).sum(-1)
                rows_J.append(Je)
                rows_aref.append(-b * ve - k * d_imp * dist)
                rows_R.append(R_con)
                rows_active.append(active)
        if self._lim_dofs:
            q = qpos[:, c.lim_dofs]
            k, b = self._kb(c.lim_solref, c.lim_solimp[:, 1])
            nl = len(self._lim_dofs)
            for side, dist in enumerate((q - c.lim_lo, c.lim_hi - q)):
                d_imp = self._impedance(c.lim_solimp,
                                        torch.clamp(-dist, min=0.0))
                d_eff = torch.clamp(d_imp, 1e-6, 1.0 - 1e-6)
                J = c.lim_J[side * nl:(side + 1) * nl].expand(
                    qpos.shape[0], nl, m.nv)
                ve = (J * qvel[:, None, :]).sum(-1)
                rows_J.append(J)
                rows_aref.append(-b * ve - k * d_imp * dist)
                rows_R.append((1.0 - d_eff) / d_eff * c.lim_invw)
                rows_active.append(dist < 0.0)
        if not rows_J:
            return None
        return (torch.cat(rows_J, dim=1), torch.cat(rows_aref, dim=1),
                torch.cat(rows_R, dim=1), torch.cat(rows_active, dim=1))

    # -- forward + integrate --------------------------------------------

    def _forward(self, qpos, qvel, ctrl):
        """Constrained forward dynamics (planar_physics.py:616-694): (qacc,
        M, qfrc_smooth, qfrc_constraint), each batched."""
        m = self.m
        dtype = qpos.dtype
        c = self.consts(qpos.device, dtype)
        M, bias, poses, lin = self._smooth(qpos, qvel)
        passive = -c.stiffness * (qpos - c.springref) - c.damping * qvel
        qfrc_smooth = self._actuation(ctrl, dtype) + passive - bias
        L = torch.linalg.cholesky_ex(M)[0]
        qacc_smooth = _chol_solve(L, qfrc_smooth[..., None])[..., 0]

        rows = self._constraint_rows(qpos, qvel, poses, lin)
        if rows is None:
            return qacc_smooth, M, qfrc_smooth, torch.zeros_like(qvel)
        J, aref, R, active = rows
        Minv_Jt = _chol_solve(L, J.transpose(1, 2))   # (B, nv, nr)
        A = J @ Minv_Jt
        b_vec = (J @ qacc_smooth[..., None])[..., 0] - aref
        mask = active.to(dtype)
        # min 1/2 f^T (A + R) f + f^T b over f >= 0, masked rows
        AR = A + torch.diag_embed(R)
        diag = torch.clamp(torch.diagonal(AR, dim1=1, dim2=2), min=1e-10)
        f = torch.zeros_like(b_vec)
        if self.solver == "pgs":
            # one row at a time in five launches: g_i = AR_i f + b_i, then
            # f_i = max(f_i - g_i / AR_ii, 0) masked
            nr = f.shape[1]
            fc = f[:, :, None]
            for _ in range(self.solver_iters):
                for i in range(nr):
                    g = torch.baddbmm(b_vec[:, i, None, None],
                                      AR[:, i:i + 1], fc)[:, 0, 0]
                    f[:, i] = torch.clamp(
                        torch.addcdiv(f[:, i], g, diag[:, i], value=-1.0),
                        min=0.0) * mask[:, i]
        else:
            # FISTA on the D^-1/2-scaled problem, the step from the scaled
            # matrix's Gershgorin bound (planar_physics.py:662-690)
            dhalf = torch.sqrt(diag)
            At = AR / (dhalf[:, :, None] * dhalf[:, None, :])
            bt = b_vec / dhalf
            At_m = At * mask[:, :, None] * mask[:, None, :]
            alpha = 1.0 / torch.clamp(At_m.abs().sum(-1).amax(-1),
                                      min=1.0)[:, None]
            ft = ft_prev = f
            bt = bt[..., None]
            for k in range(self.solver_iters):
                # y = ft + beta (ft - ft_prev), beta = k / (k + 3); five
                # launches an iteration
                y = torch.lerp(ft_prev, ft, 1.0 + k / (k + 3.0))
                g = torch.baddbmm(bt, At, y[..., None])[..., 0]
                ft, ft_prev = torch.clamp(torch.addcmul(y, alpha, g,
                                                        value=-1.0),
                                          min=0.0) * mask, ft
            f = ft / dhalf
        qfrc_con = (J.transpose(1, 2) @ f[..., None])[..., 0]
        qacc = qacc_smooth + (Minv_Jt @ f[..., None])[..., 0]
        return qacc, M, qfrc_smooth, qfrc_con

    def step(self, qpos, qvel, ctrl):
        """One MuJoCo timestep with the model's own integrator."""
        if self.m.integrator == "rk4":
            return self._step_rk4(qpos, qvel, ctrl)
        return self._step_euler(qpos, qvel, ctrl)

    def _step_euler(self, qpos, qvel, ctrl):
        """MuJoCo Euler with implicit joint damping (planar_physics.py:
        702-718): (M + h D) v+ = M v + h (qfrc_smooth + D v + qfrc_con)."""
        h = self.m.timestep
        damping = self.consts(qpos.device, qpos.dtype).damping
        _, M, qfrc_smooth, qfrc_con = self._forward(qpos, qvel, ctrl)
        qfrc_total = qfrc_smooth + qfrc_con + damping * qvel
        MhD = M + h * torch.diag(damping)
        L = torch.linalg.cholesky_ex(MhD)[0]
        rhs = (M @ qvel[..., None])[..., 0] + h * qfrc_total
        qvel_new = _chol_solve(L, rhs[..., None])[..., 0]
        return qpos + h * qvel_new, qvel_new

    def _step_rk4(self, qpos, qvel, ctrl):
        """MuJoCo's 4-stage Runge-Kutta on (qpos, qvel), a full constrained
        forward per stage, damping explicit (planar_physics.py:720-741)."""
        h = self.m.timestep
        A = ((0.5, 0.0, 0.0), (0.0, 0.5, 0.0), (0.0, 0.0, 1.0))
        B = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)
        kv = [qvel]
        ka = [self._forward(qpos, qvel, ctrl)[0]]
        for i in range(3):
            dq = sum(A[i][j] * kv[j] for j in range(len(kv)))
            dv = sum(A[i][j] * ka[j] for j in range(len(ka)))
            qi = qpos + h * dq
            vi = qvel + h * dv
            kv.append(vi)
            ka.append(self._forward(qi, vi, ctrl)[0])
        qpos_new = qpos + h * sum(b * k for b, k in zip(B, kv))
        qvel_new = qvel + h * sum(b * k for b, k in zip(B, ka))
        return qpos_new, qvel_new

    def env_step(self, qpos, qvel, ctrl, frame_skip: int):
        """A gym step: ``frame_skip`` timesteps with the control held."""
        for _ in range(frame_skip):
            qpos, qvel = self.step(qpos, qvel, ctrl)
        return qpos, qvel


def export_models(out_dir: str = MODEL_DIR) -> list:
    """Write the exact and the search model of every env with a search
    contact set into ``out_dir``; returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for env_name, geoms in SEARCH_GEOMS.items():
        for search in (False, True):
            model = extract_planar_model(env_name, geoms if search else None)
            path = os.path.join(out_dir, os.path.basename(
                model_path(env_name, search)))
            save_planar_model(model, path)
            paths.append(path)
    return paths


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Extract the planar models from the installed gymnasium "
                    "and mujoco into planar_models/")
    p.add_argument("--export", action="store_true", required=True)
    p.add_argument("--out-dir", type=str, default=MODEL_DIR)
    args = p.parse_args(argv)
    for path in export_models(args.out_dir):
        print(path)


if __name__ == "__main__":
    main()
