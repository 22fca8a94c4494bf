"""Contact sample points from an MJCF's collision geoms, with NumPy and
xml.etree only.

A plain copy of booster_gym_torch/model/mjcf_points.py and of the MJCF
geom reader it calls (eval/mujoco_eval.py's load_mjcf_geoms), so that the
yardstick does not move with the program.  The standup task samples its
contact points from the MJCF collision geoms in place of the URDF's
primitives: a capsule is a swept sphere, so stations along its axis with
the capsule's radius reproduce its surface for the sphere-vs-terrain
contact test; a box gives its 8 corners, a cylinder two rims of 6, a
sphere its center with its radius.

The merged-body frame quirk is kept as the program has it from the JAX
package: a geom whose body the URDF merged into an ancestor (the palms
into the hands) keeps its pos and quat in its own body's frame and is
attached to that ancestor unchanged, without the merged joint's offset.
"""

import dataclasses
import xml.etree.ElementTree as ET

import numpy as np

# MuJoCo's built-in geom defaults for the attributes read here (size: the
# classes' own, all zeros at the root)
_GEOM_DEFAULTS = {"type": "sphere", "contype": "1", "conaffinity": "1", "pos": "0 0 0",
                  "quat": "1 0 0 0"}
_READ = ("type", "size", "contype", "conaffinity", "pos", "quat", "fromto")
_ORIENTATIONS = ("euler", "axisangle", "xyaxes", "zaxis")


def _floats(text):
    return np.array([float(v) for v in text.split()], np.float64)


def _unit_quat(q):
    return q / np.linalg.norm(q)


def quat_z_to_vec(vec):
    """MuJoCo's mju_quatZ2Vec: the unit quaternion (w, x, y, z) that turns
    +z onto `vec` about the axis z x vec."""
    v = np.asarray(vec, np.float64)
    n = np.linalg.norm(v)
    if n < 1e-15:
        return np.array([1.0, 0.0, 0.0, 0.0])
    v = v / n
    axis = np.cross([0.0, 0.0, 1.0], v)
    s = np.linalg.norm(axis)
    if s < 1e-15:
        return np.array([1.0, 0.0, 0.0, 0.0]) if v[2] > 0 else np.array([0.0, 1.0, 0.0, 0.0])
    axis = axis / s
    ang = np.arctan2(s, v[2])
    return np.concatenate([[np.cos(ang / 2)], np.sin(ang / 2) * axis])


def _merge_size(base, text):
    """A size attribute's values over the first components of `base`: the
    compiler keeps the components an attribute leaves out."""
    size = np.array(base, np.float64)
    given = _floats(text)
    size[:len(given)] = given
    return size


def _default_classes(root):
    """{class name: {attribute: value}} of the geom defaults, each class
    holding its ancestors' values under its own; the top <default> is
    "main"."""
    classes = {}

    def walk(elem, inherited):
        attrs = dict(inherited)
        geom = elem.find("geom")
        if geom is not None:
            for key in _ORIENTATIONS:
                if key in geom.attrib:
                    raise NotImplementedError(
                        f"geom default class {elem.get('class', 'main')!r} sets '{key}'")
            attrs.update({k: v for k, v in geom.attrib.items() if k in _READ and k != "size"})
            if "size" in geom.attrib:
                attrs["size"] = _merge_size(attrs["size"], geom.get("size"))
        classes[elem.get("class", "main")] = attrs
        for child in elem.findall("default"):
            walk(child, attrs)

    for top in root.findall("default"):
        walk(top, {"size": np.zeros(3)})
    classes.setdefault("main", {"size": np.zeros(3)})
    return classes


def _check_orientation(elem, what):
    for key in _ORIENTATIONS:
        if key in elem.attrib:
            raise NotImplementedError(
                f"{what} {elem.get('name', '(unnamed)')!r} is oriented by '{key}'; only 'quat' "
                f"(and 'fromto' on capsules and cylinders) is read")


def load_mjcf_geoms(path):
    """Every geom of the MJCF at `path`, in MuJoCo's geom order, as dicts:
    "body", "chain" (that body's name and its ancestors' up to the
    worldbody's child), "type", "size" [3], "pos" [3] and "quat" [4]
    (w, x, y, z) in its own body's frame, "contype", "conaffinity".  A
    `fromto` capsule or cylinder is placed as MuJoCo's compiler places it:
    pos at the midpoint, half-length |b - a| / 2, quat turning +z onto
    a - b."""
    root = ET.parse(path).getroot()
    classes = _default_classes(root)
    world = root.find("worldbody")
    if world is None:
        raise ValueError(f"{path} has no <worldbody>")
    geoms = []

    def attr(elem, cls, key):
        if key in elem.attrib:
            return elem.get(key)
        if cls not in classes:
            raise ValueError(f"{path}: unknown default class {cls!r}")
        return classes[cls].get(key, _GEOM_DEFAULTS.get(key))

    def walk(body, name, chain, childclass):
        if body.find("frame") is not None:
            raise NotImplementedError(f"{path}: <frame> elements are not read")
        for g in body.findall("geom"):
            _check_orientation(g, "geom")
            cls = g.get("class", childclass)
            kind = attr(g, cls, "type")
            size = _merge_size(classes[cls]["size"], g.get("size", ""))
            fromto = attr(g, cls, "fromto")
            if fromto is not None:
                if kind not in ("capsule", "cylinder"):
                    raise NotImplementedError(f"{path}: fromto on a {kind} geom")
                a, b = _floats(fromto)[:3], _floats(fromto)[3:6]
                pos, quat = 0.5 * (a + b), quat_z_to_vec(a - b)
                size[1] = 0.5 * np.linalg.norm(b - a)
            else:
                pos, quat = _floats(attr(g, cls, "pos")), _unit_quat(_floats(attr(g, cls, "quat")))
            geoms.append(dict(body=name, chain=chain, type=kind, size=size, pos=pos, quat=quat,
                              contype=int(attr(g, cls, "contype")),
                              conaffinity=int(attr(g, cls, "conaffinity"))))
        for child in body.findall("body"):
            _check_orientation(child, "body")
            cname = child.get("name")
            walk(child, cname, (cname, *chain), child.get("childclass", childclass))

    walk(world, "world", (), "main")
    return geoms


def _quat_to_mat(q_wxyz):
    w, x, y, z = q_wxyz
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _geom_points(kind, size, spacing):
    """Sample points (geom frame) and radii of one MJCF geom."""
    if kind == "sphere":
        return np.zeros((1, 3)), np.array([size[0]])
    if kind == "capsule":
        r, hl = float(size[0]), float(size[1])
        k = max(2, int(np.ceil(2 * hl / spacing)) + 1)
        s = np.linspace(-hl, hl, k)
        return np.stack([np.zeros(k), np.zeros(k), s], axis=-1), np.full(k, r)
    if kind == "box":
        hx, hy, hz = size[:3]
        corners = np.array([[hx * a, hy * b, hz * c]
                            for a in (-1, 1) for b in (-1, 1) for c in (-1, 1)])
        return corners, np.zeros(8)
    if kind == "cylinder":
        r, hl = float(size[0]), float(size[1])
        angles = 2 * np.pi * np.arange(6) / 6
        ring = np.stack([r * np.cos(angles), r * np.sin(angles), np.zeros(6)], axis=-1)
        return np.concatenate([ring + [0, 0, hl], ring + [0, 0, -hl]]), np.zeros(12)
    raise NotImplementedError(f"MJCF geom type {kind}")


def with_mjcf_collision(model, mjcf_path, spacing=0.03):
    """RobotModel with its contact point set rebuilt from the MJCF's
    collision geoms (contype or conaffinity non-zero; planes are the
    ground).  Each geom goes to the nearest body of its MJCF ancestry that
    is one of the model's bodies."""
    point_body, point_pos, point_radius, point_shape, shape_body = [], [], [], [], []
    for g in load_mjcf_geoms(mjcf_path):
        if g["contype"] == 0 and g["conaffinity"] == 0:
            continue
        if g["type"] == "plane":
            continue
        name = next((n for n in g["chain"] if n in model.body_names), None)
        if name is None:
            raise ValueError(f"MJCF geom on body {g['body']} has no movable ancestor among "
                             f"{model.body_names}")
        body_idx = model.body_index(name)
        pts, radii = _geom_points(g["type"], g["size"], spacing)
        # the geom's own body frame, even where that body was merged (above)
        pts = g["pos"] + pts @ _quat_to_mat(g["quat"]).T
        sid = len(shape_body)
        shape_body.append(body_idx)
        point_body.extend([body_idx] * len(pts))
        point_pos.append(pts)
        point_radius.append(radii)
        point_shape.extend([sid] * len(pts))
    if not shape_body:
        raise ValueError(f"no collision geoms found in {mjcf_path}")
    return dataclasses.replace(
        model,
        point_body=np.array(point_body, dtype=np.int32),
        point_pos=np.concatenate(point_pos).astype(np.float64),
        point_radius=np.concatenate(point_radius).astype(np.float64),
        point_shape=np.array(point_shape, dtype=np.int32),
        shape_body=np.array(shape_body, dtype=np.int32),
    )
