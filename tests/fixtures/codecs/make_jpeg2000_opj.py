"""JPEG 2000 fixtures that neither cv2 nor PIL can write, made by the
system OpenJPEG (``libopenjp2.so.7``, 2.5) through ctypes: its encoder's
code-block styles (bypass, reset, termination on every pass, vertically
causal, predictable termination, segmentation symbols), SOP and EPH
markers, ROI max-shift, tile-parts by resolution, layer or component, POC
entries, TLM and PLT markers, 12-bit samples and subsampled components.
``opj_cparameters_t`` is not declared from a header (there is none here):
``OFF`` holds the offsets of the fields set, found by filling the struct
with ``opj_set_default_encoder_parameters`` (``numresolution`` at 5600 and
``subsampling_dx`` at 18196 carry its defaults 6 and 1). ``make_digests.py``
writes these files beside the others and cv2 decodes each for the digests;
the tests read the committed files and never need the library.
"""

import ctypes
import os
import struct
import tempfile

import numpy as np

# opj_cparameters_t (OpenJPEG 2.5, x86-64): the byte offsets of the fields set
OFF = dict(tile_size_on=0, cp_tdx=12, cp_tdy=16, cp_disto_alloc=20, csty=48, prog_order=52, POC=56, numpocs=4792,
           tcp_numlayers=4796, tcp_rates=4800, numresolution=5600, cblockw_init=5604, cblockh_init=5608, mode=5612,
           irreversible=5616, roi_compno=5620, roi_shift=5624, res_spec=5628, prcw_init=5632, prch_init=5764,
           tp_on=18696, tp_flag=18697, tcp_mct=18698)
SIZEOF, POC_SIZE = 18720, 148
# opj_image_t: comps at 24; opj_image_comp_t: 64 bytes, data at 48
IMAGE_COMPS, COMP_SIZE, COMP_DATA = 24, 64, 48
_LIB = []


def lib() -> ctypes.CDLL:
    if not _LIB:
        L, p = ctypes.CDLL("libopenjp2.so.7"), ctypes.c_void_p
        for name, res, args in (("opj_image_create", p, [ctypes.c_uint32, p, ctypes.c_int]),
                                ("opj_create_compress", p, [ctypes.c_int]),
                                ("opj_setup_encoder", ctypes.c_int, [p, p, p]),
                                ("opj_encoder_set_extra_options", ctypes.c_int, [p, p]),
                                ("opj_stream_create_default_file_stream", p, [ctypes.c_char_p, ctypes.c_int]),
                                ("opj_start_compress", ctypes.c_int, [p, p, p]),
                                ("opj_encode", ctypes.c_int, [p, p]), ("opj_end_compress", ctypes.c_int, [p, p]),
                                ("opj_stream_destroy", None, [p]), ("opj_destroy_codec", None, [p]),
                                ("opj_image_destroy", None, [p]), ("opj_set_default_encoder_parameters", None, [p])):
            fn = getattr(L, name)
            fn.restype, fn.argtypes = res, args
        _LIB.append(L)
    return _LIB[0]


def encode(img, jp2=False, prec=8, sub=None, irreversible=False, mode=0, csty=0, numres=None, cblk=(64, 64),
           prog=0, rates=None, roi=None, tp_flag=None, mct=0, pocs=(), tile=None, precincts=None, extra=()):
    """OpenJPEG's codestream (or JP2) of an (H, W[, C]) array: ``mode`` the
    code-block style bits, ``csty`` SOP (2) and EPH (4), ``roi`` (component,
    shift), ``tp_flag`` "R", "L" or "C", ``pocs`` (tile, resno0, compno0,
    layno1, resno1, compno1, order) entries, ``rates`` one per layer,
    ``sub`` per-component (dx, dy), ``extra`` options such as "TLM=YES"."""
    L = lib()
    img = np.asarray(img)
    img = img[..., None] if img.ndim == 2 else img
    h, w, nc = img.shape
    sub = sub or [(1, 1)] * nc
    params = (ctypes.c_uint32 * (9 * nc))()  # opj_image_cmptparm_t: dx dy w h x0 y0 prec bpp sgnd
    for c, (dx, dy) in enumerate(sub):
        params[9 * c:9 * c + 9] = [dx, dy, -(-w // dx), -(-h // dy), 0, 0, prec, prec, 0]
    image = L.opj_image_create(nc, params, 1 if nc >= 3 else 2)  # sRGB or greyscale
    ctypes.memmove(image, struct.pack("<4I", 0, 0, w, h), 16)
    comps = ctypes.c_void_p.from_address(image + IMAGE_COMPS).value
    for c, (dx, dy) in enumerate(sub):
        plane = np.ascontiguousarray(img[::dy, ::dx, c].astype(np.int32))
        ctypes.memmove(ctypes.c_void_p.from_address(comps + COMP_SIZE * c + COMP_DATA).value, plane.ctypes.data,
                       plane.nbytes)
    prm = (ctypes.c_ubyte * SIZEOF)()
    L.opj_set_default_encoder_parameters(prm)

    def put(field, value, k=0, fmt="<i"):
        struct.pack_into(fmt, prm, OFF[field] + 4 * k, value)

    rates = rates or [0.0]
    for field, value in (("cblockw_init", cblk[0]), ("cblockh_init", cblk[1]), ("mode", mode),
                         ("irreversible", int(irreversible)), ("csty", csty | (1 if precincts else 0)),
                         ("prog_order", prog), ("tcp_numlayers", len(rates)), ("cp_disto_alloc", 1)):
        put(field, value)
    for k, r in enumerate(rates):
        put("tcp_rates", r, k, "<f")
    if numres is not None:
        put("numresolution", numres)
    if roi:
        put("roi_compno", roi[0])
        put("roi_shift", roi[1])
    if tp_flag:
        prm[OFF["tp_on"]], prm[OFF["tp_flag"]] = 1, ord(tp_flag)
    prm[OFF["tcp_mct"]] = mct
    if tile:
        put("tile_size_on", 1)
        put("cp_tdx", tile[0])
        put("cp_tdy", tile[1])
    if precincts:
        put("res_spec", len(precincts))
        for k, (pw, ph) in enumerate(precincts):
            put("prcw_init", pw, k)
            put("prch_init", ph, k)
    for k, (t, r0, c0, l1, r1, c1, prg) in enumerate(pocs):  # opj_poc_t: resno0.. at 0, prg1 at 32, tile at 48
        struct.pack_into("<5I", prm, OFF["POC"] + POC_SIZE * k, r0, c0, l1, r1, c1)
        struct.pack_into("<i", prm, OFF["POC"] + POC_SIZE * k + 32, prg)
        struct.pack_into("<I", prm, OFF["POC"] + POC_SIZE * k + 48, t)
    put("numpocs", len(pocs))
    codec = L.opj_create_compress(2 if jp2 else 0)  # OPJ_CODEC_JP2 or OPJ_CODEC_J2K
    fd, path = tempfile.mkstemp(suffix=".j2k")
    os.close(fd)
    try:
        if not L.opj_setup_encoder(codec, prm, image):
            raise RuntimeError("opj_setup_encoder refused the parameters")
        if extra:
            opts = (ctypes.c_char_p * (len(extra) + 1))(*[e.encode() for e in extra], None)
            if not L.opj_encoder_set_extra_options(codec, opts):
                raise RuntimeError(f"extra options {extra} refused")
        stream = L.opj_stream_create_default_file_stream(path.encode(), 0)
        ok = (L.opj_start_compress(codec, image, stream) and L.opj_encode(codec, stream)
              and L.opj_end_compress(codec, stream))
        L.opj_stream_destroy(stream)
        if not ok:
            raise RuntimeError("OpenJPEG's encoder failed")
        with open(path, "rb") as f:
            return f.read()
    finally:
        os.remove(path)
        L.opj_destroy_codec(codec)
        L.opj_image_destroy(image)


def fixtures() -> dict:
    """Each feature on a 40x52 RGB picture (``make_jpeg2000.picture``), most
    with two or three layers so that passes are cut short."""
    from make_jpeg2000 import join, packed_headers, picture, split

    rgb = picture(40, 52, 3, 21)
    out = {}
    styles = {"bypass": 1, "reset": 2, "termall": 4, "vsc": 8, "pterm": 16, "segsym": 32, "bypass_termall": 5,
              "reset_vsc_segsym": 42, "all": 63}
    for name, mode in styles.items():
        for irr in (False, True):
            out[f"opj_style_{name}_{'97' if irr else '53'}.j2k"] = encode(rgb, mode=mode, irreversible=irr,
                                                                          rates=[30, 10, 3])
    out["opj_sop.j2k"] = encode(rgb, csty=2, rates=[20, 5])
    out["opj_eph.j2k"] = encode(rgb, csty=4, rates=[20, 5])
    out["opj_sop_eph_97.j2k"] = encode(rgb, csty=6, irreversible=True, rates=[30, 10, 2])
    out["opj_eph_tiles.j2k"] = encode(rgb, csty=4, tile=(20, 20), numres=3, rates=[20, 5])
    out["opj_roi_53.j2k"] = encode(rgb, roi=(0, 5), rates=[10])
    out["opj_roi_97.j2k"] = encode(rgb, roi=(1, 7), irreversible=True, rates=[20, 4])
    for flag in "RLC":
        out[f"opj_tile_parts_{flag}.j2k"] = encode(rgb, tp_flag=flag, rates=[20, 5])
    out["opj_tile_parts_R_tiles_97.j2k"] = encode(rgb, tp_flag="R", tile=(24, 24), numres=3, irreversible=True,
                                                 rates=[20, 5])
    out["opj_poc.j2k"] = encode(rgb, rates=[20, 5], pocs=[(1, 0, 0, 2, 3, 3, 1), (1, 3, 0, 2, 6, 3, 4)])
    out["opj_mct_53.j2k"] = encode(rgb, mct=1, rates=[15])
    out["opj_mct_97.jp2"] = encode(rgb, mct=1, irreversible=True, jp2=True)
    out["opj_tlm_plt.j2k"] = encode(rgb, rates=[20, 5], extra=("TLM=YES", "PLT=YES"))
    out["opj_precincts_cprl.j2k"] = encode(rgb, prog=4, precincts=[(32, 32), (16, 16), (8, 8)], cblk=(8, 8),
                                           numres=4, rates=[20, 5])
    eph = encode(rgb, csty=4, rates=[20, 5], extra=("PLT=YES",))
    out["opj_ppt.j2k"] = packed_headers(eph, ppm=False)
    out["opj_ppt_3_segments.j2k"] = packed_headers(eph, ppm=False, pieces=3)
    out["opj_ppm_3_segments.j2k"] = packed_headers(eph, ppm=True, pieces=3)
    tiled = encode(rgb, csty=6, tile=(20, 20), numres=3, tp_flag="R", irreversible=True, rates=[20, 5],
                   extra=("PLT=YES",))
    out["opj_ppm_tiles_tile_parts_97.j2k"] = packed_headers(tiled, ppm=True, pieces=2)
    out["opj_ppt_tiles_tile_parts_97.j2k"] = packed_headers(tiled, ppm=False, pieces=2)
    main, parts = split(packed_headers(eph, ppm=True))  # PPM segments cut and numbered otherwise
    rest, body = main[:-1], main[-1][1][1:]
    for name, segs in (("nppm_split", [(0, body[:2]), (1, body[2:])]), ("zppm_twice", [(0, body[:20]), (0, body[20:])]),
                       ("zppm_gap", [(0, body[:20]), (5, body[20:])]), ("short", [(0, body[:-3])])):
        out[f"opj_ppm_{name}.j2k"] = join(rest + [(b"\xff\x60", bytes([z]) + b) for z, b in segs], parts)
    main, parts = split(packed_headers(eph, ppm=False, pieces=2))
    segs = parts[0][3]
    parts[0] = parts[0][:3] + (segs[:-1] + [(b"\xff\x61", bytes([1]) + segs[-1][1][1:])],) + parts[0][4:]
    out["opj_ppt_zppt_twice.j2k"] = join(main, parts)
    out["opj_gray_12bit.j2k"] = encode(picture(40, 52, 1, 22).astype(np.uint16) * 16, prec=12)
    out["refused_opj_subsampled.j2k"] = encode(rgb, sub=[(1, 1), (2, 2), (2, 2)])
    return out
