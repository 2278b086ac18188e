"""Dependency-free PLY I/O, numpy only (port of ``tpu3dlm/data/ply.py``):
point clouds ascii and binary (``load_ply`` / ``save_ply``) and binary
triangle meshes (``save_ply_mesh`` / ``load_ply_mesh``, the map stage's
``map_mesh.ply``, byte for byte the JAX writer's).

The pipeline reads the two scans' ``cloud.ply`` with ``load_ply`` and hands
the points to ``alignment.align.Alignment``. NaN/inf points are dropped on
load, as Open3D's ``read_point_cloud(remove_nan_points=True,
remove_infinite_points=True)`` does in the system this rebuilds.
"""

from __future__ import annotations

import numpy as np

_PLY_DTYPES = {
    "char": "i1",
    "int8": "i1",
    "uchar": "u1",
    "uint8": "u1",
    "short": "i2",
    "int16": "i2",
    "ushort": "u2",
    "uint16": "u2",
    "int": "i4",
    "int32": "i4",
    "uint": "u4",
    "uint32": "u4",
    "float": "f4",
    "float32": "f4",
    "double": "f8",
    "float64": "f8",
}


def load_ply(path: str) -> tuple[np.ndarray, np.ndarray | None]:
    """Read a PLY file → (points (N, 3) float32, colors (N, 3) float32 in [0,1] or None)."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        n_vertices = 0
        props: list[tuple[str, str]] = []  # (dtype, name) of the vertex element
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                in_vertex = tokens[1] == "vertex"
                if in_vertex:
                    n_vertices = int(tokens[2])
            elif tokens[0] == "property" and in_vertex:
                if tokens[1] == "list":
                    raise ValueError("list properties not supported on vertex element")
                props.append((_PLY_DTYPES[tokens[1]], tokens[2]))
            elif tokens[0] == "end_header":
                break

        names = [name for _, name in props]
        if fmt == "ascii":
            rows = []
            for k in range(n_vertices):
                tok = f.readline().split()
                if len(tok) != len(props):
                    raise ValueError(
                        f"truncated ascii PLY: vertex {k} has {len(tok)} "
                        f"values, expected {len(props)}"
                    )
                rows.append(tok)
            # explicit 2-D shape: np.array([]) is 1-D and the column
            # indexing below would IndexError on a legitimate 0-vertex file
            arr = np.array(rows, dtype=np.float64).reshape(n_vertices, len(props))
            data = {name: arr[:, i] for i, (_, name) in enumerate(props)}
        elif fmt == "binary_little_endian":
            dtype = np.dtype([(name, "<" + dt) for dt, name in props])
            raw = np.frombuffer(f.read(dtype.itemsize * n_vertices), dtype=dtype)
            data = {name: raw[name] for name in names}
        elif fmt == "binary_big_endian":
            dtype = np.dtype([(name, ">" + dt) for dt, name in props])
            raw = np.frombuffer(f.read(dtype.itemsize * n_vertices), dtype=dtype)
            data = {name: raw[name] for name in names}
        else:
            raise ValueError(f"unsupported PLY format {fmt}")

    pts = np.stack([data["x"], data["y"], data["z"]], axis=1).astype(np.float32)
    colors = None
    if all(k in data for k in ("red", "green", "blue")):
        colors = np.stack([data["red"], data["green"], data["blue"]], axis=1).astype(
            np.float32
        )
        # scale by the DECLARED property type: a value heuristic
        # (max > 1) leaves a near-black uchar cloud (all 0/1 values)
        # saturated instead of ~1/255
        dtype_of = {name: dt for dt, name in props}
        if dtype_of.get("red") == "u1":
            colors = colors / 255.0
        elif colors.max(initial=0.0) > 1.0:  # float colors stored 0-255
            colors = colors / 255.0
    finite = np.isfinite(pts).all(axis=1)
    pts = pts[finite]
    if colors is not None:
        colors = colors[finite]
    return pts, colors


def save_ply(
    path: str,
    points: np.ndarray,
    colors: np.ndarray | None = None,
    binary: bool = True,
) -> None:
    """Write (N, 3) points (+ optional [0,1] float colors) as a PLY file."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    header = ["ply"]
    header.append(
        "format binary_little_endian 1.0" if binary else "format ascii 1.0"
    )
    header.append(f"element vertex {n}")
    header += ["property float x", "property float y", "property float z"]
    if colors is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if colors is not None:
            c8 = np.clip(np.asarray(colors) * 255.0, 0, 255).astype(np.uint8)
            if binary:
                dtype = np.dtype(
                    [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"), ("green", "u1"), ("blue", "u1")]
                )
                rec = np.empty(n, dtype=dtype)
                rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
                rec["red"], rec["green"], rec["blue"] = c8[:, 0], c8[:, 1], c8[:, 2]
                f.write(rec.tobytes())
            else:
                for p, c in zip(points, c8):
                    f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n".encode())
        else:
            if binary:
                f.write(points.astype("<f4").tobytes())
            else:
                for p in points:
                    f.write(f"{p[0]} {p[1]} {p[2]}\n".encode())


def save_ply_mesh(
    path: str,
    vertices: np.ndarray,
    faces: np.ndarray,
    colors: np.ndarray | None = None,
) -> None:
    """Write a triangle mesh ((V, 3) float vertices, (F, 3) int faces,
    optional per-vertex [0,1] colors) as binary PLY."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    nv, nf = vertices.shape[0], faces.shape[0]
    header = [
        "ply",
        "format binary_little_endian 1.0",
        f"element vertex {nv}",
        "property float x",
        "property float y",
        "property float z",
    ]
    if colors is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += [
        f"element face {nf}",
        "property list uchar int vertex_indices",
        "end_header",
    ]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if colors is not None:
            c8 = np.clip(np.asarray(colors) * 255.0, 0, 255).astype(np.uint8)
            dtype = np.dtype(
                [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                 ("red", "u1"), ("green", "u1"), ("blue", "u1")]
            )
            rec = np.empty(nv, dtype=dtype)
            rec["x"], rec["y"], rec["z"] = vertices[:, 0], vertices[:, 1], vertices[:, 2]
            rec["red"], rec["green"], rec["blue"] = c8[:, 0], c8[:, 1], c8[:, 2]
            f.write(rec.tobytes())
        else:
            f.write(vertices.astype("<f4").tobytes())
        fdtype = np.dtype([("n", "u1"), ("i", "<i4", (3,))])
        frec = np.empty(nf, dtype=fdtype)
        frec["n"] = 3
        frec["i"] = faces
        f.write(frec.tobytes())


def load_ply_mesh(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a binary PLY triangle mesh written by `save_ply_mesh` →
    ((V, 3) float32 vertices, (F, 3) int32 faces)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        nv = nf = 0
        vprops: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline()
            if not line:  # readline at EOF returns b"" forever → guard or spin
                raise ValueError("unexpected EOF in PLY header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens:
                continue
            if tokens[0] == "element":
                in_vertex = tokens[1] == "vertex"
                if in_vertex:
                    nv = int(tokens[2])
                elif tokens[1] == "face":
                    nf = int(tokens[2])
            elif tokens[0] == "property" and in_vertex and tokens[1] != "list":
                vprops.append((_PLY_DTYPES[tokens[1]], tokens[2]))
            elif tokens[0] == "end_header":
                break
        vdtype = np.dtype([(name, "<" + dt) for dt, name in vprops])
        raw = np.frombuffer(f.read(vdtype.itemsize * nv), dtype=vdtype)
        verts = np.stack([raw["x"], raw["y"], raw["z"]], axis=1).astype(np.float32)
        fdtype = np.dtype([("n", "u1"), ("i", "<i4", (3,))])
        fraw = np.frombuffer(f.read(fdtype.itemsize * nf), dtype=fdtype)
        return verts, fraw["i"].astype(np.int32)
