"""Minimal offline URDF → RobotSpec loader (port of
``tpustomp/robot/urdf_lite.py``; numpy only, the spec's tensors on the CPU).

Reference equivalents (SURVEY §3.2): the ``urdf`` + ``kdl_parser`` packages
turning the robot_description XML into a KDL tree, plus
``StompRobotModel::generateCollisionPoints`` sampling spheres along links.

Scope (deliberately "lite", host-side, never in the hot path):
  - serial chains only: walks parent→child joints from `root` to `tip`
    (branches off the chain are ignored except their fixed-joint geometry);
  - joint types: revolute / continuous / prismatic / fixed (fixed joints are
    folded into the next moving joint's constant offset/rotation);
  - per-link inertial (mass, com, inertia) for the torque cost;
  - collision geometry → sphere bodies: spheres are exact for <sphere>,
    sampled along the axis for <cylinder>/<capsule>, and along the longest
    axis for <box> (radius = half the smaller cross-section), mirroring the
    reference's sphere-per-link approximation;
  - <mesh> (binary/ASCII STL and OBJ): vertex cloud covered by bounding
    spheres strung along its PCA major axis (every vertex inside a sphere
    by construction); package:// paths resolved against ``mesh_dir``.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np

from tpustomp_torch.robot.model import PRISMATIC, REVOLUTE, RobotSpec, _spec


def _rpy_matrix(rpy):
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def _origin(el):
    if el is None:
        return np.zeros(3), np.eye(3)
    xyz = np.fromstring(el.get("xyz", "0 0 0"), sep=" ")
    rpy = np.fromstring(el.get("rpy", "0 0 0"), sep=" ")
    return xyz, _rpy_matrix(rpy)


@dataclass
class _Joint:
    name: str
    jtype: str
    parent: str
    child: str
    xyz: np.ndarray
    rot: np.ndarray
    axis: np.ndarray
    lower: float
    upper: float


@dataclass
class _Link:
    name: str
    mass: float = 0.0
    com: np.ndarray = field(default_factory=lambda: np.zeros(3))
    inertia: np.ndarray = field(default_factory=lambda: np.zeros((3, 3)))
    # list of (center [3], radius) sphere bodies in the link frame
    spheres: list = field(default_factory=list)


def _parse_inertial(el):
    if el is None:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    mass = float(el.find("mass").get("value")) if el.find("mass") is not None else 0.0
    com, R = _origin(el.find("origin"))
    I = np.zeros((3, 3))
    iel = el.find("inertia")
    if iel is not None:
        ixx = float(iel.get("ixx", 0)); iyy = float(iel.get("iyy", 0))
        izz = float(iel.get("izz", 0)); ixy = float(iel.get("ixy", 0))
        ixz = float(iel.get("ixz", 0)); iyz = float(iel.get("iyz", 0))
        I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
        I = R @ I @ R.T  # rotate into the link frame
    return mass, com, I


def _densify_triangles(tris, h, max_n=16):
    """Surface-sample triangles on a barycentric grid of pitch ≤ h: [P, 3].

    Vertex clouds alone under-cover large facets (a box is 8 points); the
    sphere fit needs points *on* the surface between them.
    """
    out = [tris.reshape(-1, 3)]
    edge = np.linalg.norm(np.roll(tris, -1, axis=1) - tris, axis=2).max(axis=1)
    for (a, b, c), e in zip(tris, edge):
        n = min(max_n, int(np.ceil(e / h)))
        if n <= 1:
            continue
        i, j = np.mgrid[0:n + 1, 0:n + 1]
        m = (i + j) <= n
        u, v = i[m] / n, j[m] / n
        out.append(a + np.outer(u, b - a) + np.outer(v, c - a))
    return np.concatenate(out, axis=0)


def _load_mesh_points(path, scale):
    """Surface point cloud of an STL (binary or ASCII) or OBJ mesh, [P, 3].

    Minimal offline loaders (not in any hot path). Binary STL is detected by
    the 84 + 50·n_triangles size invariant, which is robust against binary
    files whose 80-byte header happens to start with "solid". STL facets are
    densified (barycentric grid); OBJ contributes its vertices only.
    """
    import os
    import struct

    raw = open(path, "rb").read()
    ext = os.path.splitext(path)[1].lower()
    pts = tris = None
    if ext == ".obj":
        pts = [np.fromstring(ln[2:], sep=" ")[:3]
               for ln in raw.decode("utf-8", "ignore").splitlines()
               if ln.startswith("v ")]
        pts = np.asarray(pts, np.float64)
    elif len(raw) >= 84:
        (n_tri,) = struct.unpack("<I", raw[80:84])
        if len(raw) == 84 + 50 * n_tri:      # binary STL
            body = np.frombuffer(raw[84:], dtype=np.uint8)
            tri = body.reshape(n_tri, 50)[:, :48].copy().view("<f4")
            tris = tri.reshape(n_tri, 4, 3)[:, 1:].astype(np.float64)
    if pts is None and tris is None:          # ASCII STL
        vs = [np.fromstring(ln.strip()[7:], sep=" ")
              for ln in raw.decode("utf-8", "ignore").splitlines()
              if ln.strip().startswith("vertex ")]
        if len(vs) % 3 == 0 and vs:
            tris = np.asarray(vs, np.float64).reshape(-1, 3, 3)
        else:
            pts = np.asarray(vs, np.float64)
    if tris is not None:
        tris = tris * np.asarray(scale, np.float64)
        lo, hi = tris.reshape(-1, 3).min(axis=0), tris.reshape(-1, 3).max(axis=0)
        h = max(float(np.linalg.norm(hi - lo)) / 10.0, 1e-6)
        return _densify_triangles(tris, h)
    if pts is None or pts.size == 0:
        raise ValueError(f"no vertices parsed from mesh {path!r}")
    return pts * np.asarray(scale, np.float64)


def _spheres_from_points(pts, spacing_factor=1.0):
    """Cover a vertex cloud with spheres strung along its principal axis.

    Same reduction the reference applies to every link (spheres along the
    link, StompRobotModel::generateCollisionPoints): slice the cloud into
    segments along its PCA major axis, one bounding sphere per slice. Every
    input vertex is inside some sphere by construction.
    """
    centroid = pts.mean(axis=0)
    centered = pts - centroid
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    axis = vt[0]
    t = centered @ axis                        # coordinates along the axis
    cross_r = np.sqrt(np.maximum(
        (centered ** 2).sum(axis=1) - t ** 2, 0.0)).max()
    length = t.max() - t.min()
    n = max(1, int(np.ceil(length / (2 * max(cross_r, 1e-9)
                                     * spacing_factor))))
    out = []
    edges = np.linspace(t.min() - 1e-12, t.max() + 1e-12, n + 1)
    for i in range(n):
        m = (t >= edges[i]) & (t <= edges[i + 1])
        if not np.any(m):
            continue
        seg = pts[m]
        c = seg.mean(axis=0)
        r = float(np.linalg.norm(seg - c, axis=1).max())
        out.append((c, max(r, 1e-6)))
    return out


def _spheres_from_geometry(geom_el, xyz, rot, spacing_factor=1.0,
                           mesh_dir=None):
    """Approximate one collision geometry by spheres (link frame)."""
    out = []
    sph = geom_el.find("sphere")
    if sph is not None:
        out.append((xyz, float(sph.get("radius"))))
        return out
    cyl = geom_el.find("cylinder") if geom_el.find("cylinder") is not None \
        else geom_el.find("capsule")
    if cyl is not None:
        r = float(cyl.get("radius"))
        length = float(cyl.get("length"))
        axis = rot @ np.array([0.0, 0.0, 1.0])  # URDF cylinders are z-aligned
        n = max(1, int(np.ceil(length / (2 * r * spacing_factor))))
        for i in range(n):
            t = (i + 0.5) / n - 0.5
            out.append((xyz + axis * t * length, r))
        return out
    box = geom_el.find("box")
    if box is not None:
        size = np.fromstring(box.get("size"), sep=" ")
        longest = int(np.argmax(size))
        r = float(np.sort(size)[:2].max() / 2.0)
        axis = rot @ np.eye(3)[longest]
        n = max(1, int(np.ceil(size[longest] / (2 * r * spacing_factor))))
        for i in range(n):
            t = (i + 0.5) / n - 0.5
            out.append((xyz + axis * t * size[longest], r))
        return out
    mesh = geom_el.find("mesh")
    if mesh is not None:
        import os

        fname = mesh.get("filename", "")
        # URDF meshes use package://pkg/rel/path or plain relative paths;
        # without a ROS package index, resolve against mesh_dir (falling
        # back to the basename — flat mesh directories are the common case)
        rel = fname.split("package://", 1)[-1]
        candidates = [rel]
        if mesh_dir is not None:
            candidates = [os.path.join(mesh_dir, rel),
                          os.path.join(mesh_dir, os.path.basename(rel)), rel]
        path = next((p for p in candidates if os.path.isfile(p)), None)
        if path is None:
            raise FileNotFoundError(
                f"mesh {fname!r} not found (searched {candidates}); pass "
                "mesh_dir= to load_urdf")
        scale = np.fromstring(mesh.get("scale", "1 1 1"), sep=" ")
        pts = _load_mesh_points(path, scale)
        pts = pts @ rot.T + xyz               # mesh frame → link frame
        return _spheres_from_points(pts, spacing_factor)
    return out  # unknown geometry: skip (reference uses spheres too)


_MOVING = ("revolute", "continuous", "prismatic")


def _joint_motion(j: _Joint, q: float):
    """(xyz, rot) of a frozen joint's motion at position q, in its own frame."""
    if j.jtype == "prismatic":
        return j.axis * q, np.eye(3)
    # revolute/continuous: Rodrigues rotation about the joint axis
    a = j.axis
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    R = np.eye(3) + np.sin(q) * K + (1 - np.cos(q)) * (K @ K)
    return np.zeros(3), R


def _parse_urdf(xml_text: str, sphere_spacing: float, mesh_dir):
    """Parse links/joints into host dataclasses + the tree adjacency."""
    doc = ET.fromstring(xml_text)
    links: dict[str, _Link] = {}
    for lel in doc.findall("link"):
        link = _Link(lel.get("name"))
        link.mass, link.com, link.inertia = _parse_inertial(lel.find("inertial"))
        for cel in lel.findall("collision"):
            xyz, rot = _origin(cel.find("origin"))
            gel = cel.find("geometry")
            if gel is not None:
                link.spheres += _spheres_from_geometry(gel, xyz, rot,
                                                       sphere_spacing,
                                                       mesh_dir)
        links[link.name] = link

    joints: dict[str, _Joint] = {}
    child_of: dict[str, _Joint] = {}
    children: dict[str, list[_Joint]] = {}
    for jel in doc.findall("joint"):
        xyz, rot = _origin(jel.find("origin"))
        ax_el = jel.find("axis")
        axis = (np.fromstring(ax_el.get("xyz"), sep=" ")
                if ax_el is not None else np.array([1.0, 0.0, 0.0]))
        lim = jel.find("limit")
        lower = float(lim.get("lower", -np.pi)) if lim is not None else -np.pi
        upper = float(lim.get("upper", np.pi)) if lim is not None else np.pi
        j = _Joint(jel.get("name"), jel.get("type"),
                   jel.find("parent").get("link"),
                   jel.find("child").get("link"),
                   xyz, rot, axis / (np.linalg.norm(axis) + 1e-12),
                   lower, upper)
        joints[j.name] = j
        child_of[j.child] = j
        children.setdefault(j.parent, []).append(j)
    return links, joints, child_of, children


def load_urdf_group(xml_text: str, root: str | None = None,
                    tip: str | None = None,
                    group_joints: list[str] | None = None,
                    fixed_positions: dict[str, float] | None = None,
                    sphere_spacing: float = 1.0,
                    mesh_dir: str | None = None,
                    base_pos=None, base_rot=None):
    """Parse a (possibly tree-structured) URDF and plan one joint group.

    Reference equivalents (SURVEY §3.1): ``StompRobotModel`` resolving a
    *planning group* (joint list) inside the full URDF→KDL tree, with
    whole-tree collision geometry — the reference plans the PR2 right arm
    while the torso/head/left arm remain part of the robot.

    Semantics:
      - `group_joints` (chain order not required; validated against the
        root→tip path) are the planned DOFs. None = every moving joint on
        the root→tip chain not named in `fixed_positions`.
      - every other moving joint in the tree is FROZEN at
        `fixed_positions[name]` (default 0.0) and folded into constant
        transforms — exactly like a fixed joint.
      - every link in the whole tree attaches its sphere bodies (and mass)
        to its deepest group-joint ancestor, so a gripper on the planned
        wrist moves with it;
      - links with NO group-joint ancestor (torso below the group, the
        other arm, the head) are static: their spheres are returned in
        WORLD coordinates for the caller to compose into the world SDF
        (AnalyticWorld.make(spheres=...) or an EDT bake) — the robot's own
        immobile geometry acts as obstacles, as in the reference.

    Returns (RobotSpec, static_spheres) with static_spheres a list of
    (center_xyz [3], radius) tuples in world frame.
    """
    links, joints, child_of, children = _parse_urdf(
        xml_text, sphere_spacing, mesh_dir)
    fixed_positions = dict(fixed_positions or {})

    # resolve root/tip
    all_children = set(child_of.keys())
    parents = {j.parent for j in joints.values()}
    if root is None:
        roots = [l for l in links if l not in all_children]
        if len(roots) != 1:
            raise ValueError(f"ambiguous root links {roots}; pass root=")
        root = roots[0]
    if tip is None:
        tips = [l for l in links if l not in parents]
        if len(tips) != 1:
            raise ValueError(f"ambiguous tip links {tips}; pass tip=")
        tip = tips[0]

    # root→tip chain (the group must live on it)
    chain: list[_Joint] = []
    cur = tip
    while cur != root:
        if cur not in child_of:
            raise ValueError(f"link {cur} unreachable from {root}")
        chain.append(child_of[cur])
        cur = chain[-1].parent
    chain.reverse()
    chain_moving = [j.name for j in chain if j.jtype in _MOVING]
    if group_joints is None:
        group = [n for n in chain_moving if n not in fixed_positions]
    else:
        group = [n for n in chain_moving if n in set(group_joints)]
        missing = set(group_joints) - set(group)
        if missing:
            raise ValueError(
                f"group joints {sorted(missing)} are not moving joints on "
                f"the {root}->{tip} chain (chain has {chain_moving})")
    if not group:
        raise ValueError("planning group is empty")
    group_set = set(group)

    # whole-tree DFS: carry (carrier group-joint index | -1 = world, and the
    # transform from that carrier's frame to the current link frame)
    axes, offsets, rots, lowers, uppers, limited, types = [], [], [], [], [], [], []
    masses, coms, inertias = [], [], []
    body_link, body_offset, body_radius = [], [], []
    static_spheres: list = []
    ee_offset = {"xyz": np.zeros(3)}

    base_pos_v = np.asarray(base_pos if base_pos is not None else [0.0] * 3,
                            np.float64)
    base_rot_m = np.asarray(base_rot if base_rot is not None else np.eye(3),
                            np.float64)

    def attach(link: _Link, carrier: int, T_xyz, T_rot):
        if carrier >= 0:
            if link.mass > 0:
                m_old = masses[carrier]
                com_child = T_xyz + T_rot @ link.com
                m_tot = m_old + link.mass
                com_tot = (m_old * coms[carrier]
                           + link.mass * com_child) / m_tot
                # Each inertia is about its OWN com (URDF convention /
                # RobotSpec contract), so merging needs the parallel-axis
                # transport of both tensors to the merged com:
                # I += m (||d||^2 I3 - d d^T). Adding the rotated child
                # tensor alone underestimates by the transported mass
                # terms (16x on a 2x1 kg, 0.3 m offset pair).
                def _shift(I, m, d):
                    return I + m * (float(d @ d) * np.eye(3)
                                    - np.outer(d, d))
                inertias[carrier] = (
                    _shift(inertias[carrier], m_old,
                           coms[carrier] - com_tot)
                    + _shift(T_rot @ link.inertia @ T_rot.T, link.mass,
                             com_child - com_tot))
                coms[carrier] = com_tot
                masses[carrier] = m_tot
            for center, radius in link.spheres:
                body_link.append(carrier)
                body_offset.append(T_xyz + T_rot @ center)
                body_radius.append(radius)
        else:
            for center, radius in link.spheres:
                world = base_rot_m @ (T_xyz + T_rot @ center) + base_pos_v
                static_spheres.append((world, radius))

    def visit(link_name: str, carrier: int, T_xyz, T_rot):
        attach(links[link_name], carrier, T_xyz, T_rot)
        if link_name == tip:
            if carrier != len(axes) - 1:
                raise ValueError(
                    "tip link is not carried by the last group joint "
                    "(group must end at or before the tip)")
            ee_offset["xyz"] = T_xyz
        for j in children.get(link_name, []):
            if j.name in group_set:
                if carrier != len(axes) - 1:
                    raise ValueError(
                        f"group joint {j.name} does not chain from the "
                        f"previous group joint (carrier {carrier})")
                axes.append(j.axis)
                offsets.append(T_xyz + T_rot @ j.xyz)
                rots.append(T_rot @ j.rot)
                types.append(PRISMATIC if j.jtype == "prismatic" else REVOLUTE)
                is_cont = (j.jtype == "continuous")
                limited.append(not is_cont)
                lowers.append(-np.pi if is_cont else j.lower)
                uppers.append(np.pi if is_cont else j.upper)
                masses.append(0.0)
                coms.append(np.zeros(3))
                inertias.append(np.zeros((3, 3)))
                visit(j.child, len(axes) - 1, np.zeros(3), np.eye(3))
            else:
                if j.jtype == "fixed":
                    m_xyz, m_rot = np.zeros(3), np.eye(3)
                elif j.jtype in _MOVING:
                    m_xyz, m_rot = _joint_motion(
                        j, float(fixed_positions.get(j.name, 0.0)))
                else:
                    raise ValueError(f"unsupported joint type {j.jtype}")
                n_rot = T_rot @ j.rot
                n_xyz = T_xyz + T_rot @ j.xyz + n_rot @ m_xyz
                visit(j.child, carrier, n_xyz, n_rot @ m_rot)

    visit(root, -1, np.zeros(3), np.eye(3))

    if not body_link:  # planners need at least one body; use the tip origin
        body_link, body_offset, body_radius = [len(axes) - 1], [np.zeros(3)], [0.01]

    spec = _spec(axes, offsets, np.stack(rots), lowers, uppers, limited,
                 body_link, body_offset, body_radius, joint_type=types,
                 base_pos=base_pos_v, base_rot=base_rot_m,
                 link_mass=masses, link_com=coms, link_inertia=inertias,
                 ee_offset=ee_offset["xyz"])
    return spec, static_spheres


def load_urdf(xml_text: str, root: str | None = None, tip: str | None = None,
              sphere_spacing: float = 1.0,
              mesh_dir: str | None = None) -> RobotSpec:
    """Parse a URDF string into a RobotSpec planning the full root→tip chain.

    Tree-structured URDFs are fully supported: branch geometry distal to a
    chain joint (e.g. gripper fingers) rides that joint; immobile branch
    geometry is NOT representable in a RobotSpec — use :func:`load_urdf_group`
    to receive it as static world spheres. This wrapper warns if any was
    found and dropped.
    """
    spec, static = load_urdf_group(xml_text, root=root, tip=tip,
                                   sphere_spacing=sphere_spacing,
                                   mesh_dir=mesh_dir)
    if static:
        import warnings

        warnings.warn(
            f"load_urdf: {len(static)} collision sphere(s) belong to links "
            "with no moving-joint ancestor and were dropped; use "
            "load_urdf_group() to plan a group with that geometry as static "
            "world obstacles", stacklevel=2)
    return spec


def load_urdf_file(path: str, **kw) -> RobotSpec:
    import os

    kw.setdefault("mesh_dir", os.path.dirname(os.path.abspath(path)))
    with open(path) as f:
        return load_urdf(f.read(), **kw)
