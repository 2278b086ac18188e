"""Per-frame camera calibration YAML parser and writer (port of
``tpu3dlm/data/calibration.py``).

The reference reads the file with PyYAML's ``safe_load``; the card host has
no PyYAML, so the port parses the subset of YAML that the calibration
layout uses — block mappings, block ``- x`` sequences and flow ``[a, b]``
sequences of scalars, with ints, floats and plain strings resolved as
``safe_load`` resolves them. Anything outside that subset (tags, anchors,
quoted or multi-line scalars, booleans, nulls, directives such as
OpenCV's ``%YAML:1.0``) raises ``ValueError`` naming the file rather than
being read differently from PyYAML. ``write_calibration`` writes the bytes
the reference's ``yaml.safe_dump`` writes.
"""

from __future__ import annotations

import re

import numpy as np

_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$"
)
_INF_NAN = {".inf": np.inf, "+.inf": np.inf, "-.inf": -np.inf, ".nan": np.nan}
# what safe_load resolves to something other than int/float/str
_OTHER = re.compile(
    r"^(?:yes|no|true|false|on|off|y|n|~|null|[-+]?0[0-7_]+|[-+]?0[box].*|.*:[0-5]?[0-9](?:\.[0-9_]*)?"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<|=)$",
    re.IGNORECASE,
)
_KEY = re.compile(r"^[A-Za-z_][A-Za-z0-9_.\-]*$")


class _Unsupported(ValueError):
    pass


def _scalar(text: str):
    if not text:
        raise _Unsupported("empty value (null)")
    if text[0] in "[]{}!&*|>'\"%@`#," or text.startswith("- ") or ": " in text or text.endswith(":"):
        raise _Unsupported(f"unsupported scalar {text!r}")
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    low = text.lower()
    if low in _INF_NAN and text in (".inf", ".Inf", ".INF", "+.inf", "+.Inf", "+.INF", "-.inf", "-.Inf",
                                    "-.INF", ".nan", ".NaN", ".NAN"):
        return float(_INF_NAN[low])
    if _OTHER.match(text):
        raise _Unsupported(f"scalar {text!r} is not an int, float or plain string")
    return text


def _value(text: str):
    if text.startswith("["):
        if not text.endswith("]"):
            raise _Unsupported(f"unsupported flow sequence {text!r}")
        inner = text[1:-1].strip()
        if not inner:
            return []
        return [_scalar(t.strip()) for t in inner.split(",")]
    return _scalar(text)


def _lines(text: str) -> list[tuple[int, str]]:
    out = []
    for line in text.splitlines():
        if "\t" in line[: len(line) - len(line.lstrip())]:
            raise _Unsupported("tab indentation")
        body = line.split(" #", 1)[0].rstrip() if not line.lstrip().startswith("#") else ""
        if not body.strip():
            continue
        stripped = body.strip()
        if stripped.startswith("%"):
            raise _Unsupported(f"directive {stripped!r}")
        if stripped in ("---", "..."):
            if not out or stripped == "...":
                continue
            raise _Unsupported("more than one document")
        out.append((len(body) - len(body.lstrip()), stripped))
    return out


def _block(lines, i: int, indent: int):
    """Parse the block node whose lines start at ``i`` with ``indent``."""
    if lines[i][1] == "-" or lines[i][1].startswith("- "):
        seq = []
        while i < len(lines) and lines[i][0] == indent and (lines[i][1] == "-" or lines[i][1].startswith("- ")):
            item = lines[i][1][1:].strip()
            if not item or (": " in item or item.endswith(":")):
                raise _Unsupported("nested nodes inside a sequence")
            seq.append(_value(item))
            i += 1
        return seq, i
    mapping = {}
    while i < len(lines) and lines[i][0] == indent:
        text = lines[i][1]
        key, sep, rest = text.partition(":")
        if not sep or (rest and not rest.startswith(" ")) or not _KEY.match(key):
            raise _Unsupported(f"unsupported line {text!r}")
        rest = rest.strip()
        i += 1
        if rest:
            mapping[key] = _value(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and (lines[i][1] == "-" or lines[i][1].startswith("- ")))):
            mapping[key], i = _block(lines, i, lines[i][0])
        else:
            raise _Unsupported(f"empty value for {key!r} (null)")
    return mapping, i


def parse_yaml_subset(text: str, path: str = "<string>"):
    """The subset of YAML described in the module docstring → dicts, lists,
    ints, floats and strings, as ``yaml.safe_load`` gives them."""
    try:
        lines = _lines(text)
        if not lines:
            raise _Unsupported("empty document")
        node, i = _block(lines, 0, lines[0][0])
        if i != len(lines):
            raise _Unsupported(f"unexpected indentation at {lines[i][1]!r}")
        return node
    except _Unsupported as e:
        raise ValueError(f"calibration YAML {path}: outside the supported YAML subset: {e}") from None


def load_calibration(calibration_path: str) -> dict:
    """Parse one calibration YAML; errors are pinned LOUD with the path.

    A missing file raises FileNotFoundError; a file that parses but lacks
    the RTAB-Map layout (no ``camera_matrix.data`` or a matrix shorter than
    the row-major 3x3) raises ValueError naming the file.
    """
    with open(calibration_path, "r") as f:
        data = parse_yaml_subset(f.read(), calibration_path)
    try:
        cam = data["camera_matrix"]["data"]
    except (KeyError, TypeError) as e:
        raise ValueError(
            f"calibration YAML {calibration_path} has no camera_matrix.data "
            "(not an RTAB-Map export?)"
        ) from e
    if not isinstance(cam, (list, tuple)) or len(cam) < 6:
        raise ValueError(
            f"calibration YAML {calibration_path}: camera_matrix.data must "
            f"be a row-major 3x3 (got {cam!r})"
        )
    return {
        "image_width": data.get("image_width"),
        "image_height": data.get("image_height"),
        "fx": cam[0],
        "fy": cam[4],
        "cx": cam[2],
        "cy": cam[5],
    }


def calibration_to_array(calib: dict) -> tuple[np.ndarray, np.ndarray]:
    """dict → ((fx, fy, cx, cy), (width, height)) float32 arrays."""
    intr = np.array([calib["fx"], calib["fy"], calib["cx"], calib["cy"]], np.float32)
    wh = np.array([calib["image_width"], calib["image_height"]], np.float32)
    return intr, wh


def _yaml_float(v: float) -> str:
    """A float as PyYAML's ``safe_dump`` writes it (``repr``, lower case,
    ``.0`` before a bare exponent)."""
    if v != v:
        return ".nan"
    if v in (np.inf, -np.inf):
        return ".inf" if v > 0 else "-.inf"
    text = repr(float(v)).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def write_calibration(
    calibration_path: str,
    image_width: int,
    image_height: int,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
) -> None:
    """Emit a calibration YAML in the RTAB-Map export layout, byte for byte
    what the reference's ``yaml.safe_dump`` writes (sorted keys, block
    style), so it reads back through ``parse_yaml_subset``."""
    data = [float(fx), 0.0, float(cx), 0.0, float(fy), float(cy), 0.0, 0.0, 1.0]
    lines = ["camera_matrix:", "  cols: 3", "  data:"]
    lines += [f"  - {_yaml_float(v)}" for v in data]
    lines += ["  rows: 3", f"image_height: {int(image_height)}", f"image_width: {int(image_width)}"]
    with open(calibration_path, "w") as f:
        f.write("\n".join(lines) + "\n")
