"""The MJCF side of the port, without MuJoCo (port of the parts of
booster_gym_tpu/eval/mujoco_eval.py that training needs).

load_mjcf_geoms reads an MJCF's geoms as MuJoCo's compiler places them in
their bodies' frames, with xml.etree and numpy: the machine that trains on
the card has no mujoco package, and the JAX package's load_mjcf (a
mujoco.MjModel) is reached only through that package's __init__, which
imports JAX.
"""

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
    holding its ancestors' values under its own (a size component by
    component); the top <default> is "main"."""
    classes = {}

    def walk(elem, inherited):
        attrs = dict(inherited)
        geom = elem.find("geom")
        if geom is not None:
            for key in _ORIENTATIONS:
                if key in geom.attrib:
                    raise NotImplementedError(
                        f"geom default class {elem.get('class', 'main')!r} sets '{key}'; only "
                        f"'quat' and 'fromto' orientations are read")
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
    """Every geom of the MJCF at `path`, in MuJoCo's geom order (bodies
    depth first in document order, each body's geoms in document order), as
    dicts: "body" (its body's name, "world" for the worldbody), "chain"
    (that body's name and its ancestors' up to the worldbody's child),
    "type", "size" [3], "pos" [3] and "quat" [4] (w, x, y, z) in its own
    body's frame, "contype", "conaffinity".

    Class defaults (`class`, a body's `childclass`) give the attributes a
    geom leaves out.  A `fromto` capsule or cylinder is placed as MuJoCo's
    compiler places it: pos at the midpoint, half-length |b - a| / 2 in
    size[1], and quat turning +z onto a - b (mju_quatZ2Vec of from - to, as
    the compiler calls it).  Orientations
    by euler, axisangle, xyaxes or zaxis raise NotImplementedError: their
    conventions hang on <compiler> settings this reader does not follow."""
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
