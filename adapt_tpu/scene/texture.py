"""Host-side texture records + atlas packing.

Mirrors reference bxdf/texture.py:34-96 (image / checkerboard records, bump
channel swap, <=2048 resize) and parsers/texture_packing.py:27-73 (square
atlas). Image IO uses PIL; packing uses a simple first-fit shelf packer
instead of the reference's rectpack dependency — the atlas contract (offsets
written back into each record, one square float image per tag) is identical.
"""
from __future__ import annotations

import os
import numpy as np
import xml.etree.ElementTree as xet

from ..parsers.general import rgb_parse, get

MODE_IMAGE = 0
MODE_CHECKER = 1
MODE_INVALID = -255

ATLAS_SIZES = (720, 1024, 2048, 3072, 4096)


class TextureRec:
    def __init__(self, elem: xet.Element, max_size: int = 2048):
        self.tag = elem.get("tag", "albedo")
        self.id = elem.get("id")
        self.type = elem.get("type")
        self.c1 = np.zeros(3, np.float32)
        self.c2 = np.ones(3, np.float32)
        self.scale_u = 1.0
        self.scale_v = 1.0
        self.off_x = 0
        self.off_y = 0
        self.h, self.w = 0, 0
        self.texture_img = None

        if self.type == "checkerboard":
            self.mode = MODE_CHECKER
            rgb_nodes = elem.findall("rgb")
            if len(rgb_nodes) > 0:
                self.c1 = rgb_parse(rgb_nodes[0])
            if len(rgb_nodes) > 1:
                self.c2 = rgb_parse(rgb_nodes[1])
        else:
            self.mode = MODE_IMAGE
            try:
                from PIL import Image
            except ImportError:
                raise ImportError(
                    f"texture '{self.id}' is an image texture; reading "
                    "image files needs PIL (pillow)") from None
            file_path = elem.find("string").get("value")
            if not os.path.exists(file_path):
                # missing asset: degrade to an untextured material instead of
                # refusing to render the whole scene
                import warnings
                warnings.warn(f"texture image '{file_path}' not found; "
                              f"texture '{self.id}' disabled")
                self.mode = MODE_INVALID
                return
            img = Image.open(file_path).convert("RGB")
            w, h = img.size
            if h > max_size or w > max_size:
                w, h = min(w, max_size), min(h, max_size)
                img = img.resize((w, h))
            self.w, self.h = w, h
            arr = np.asarray(img, dtype=np.float32) / 255.0
            if self.tag == "bump":
                # Up axis for bump maps is z in the asset but y in the renderer
                # (reference texture.py:74-76)
                arr = arr[..., [0, 2, 1]]
            self.texture_img = arr

        for f in elem.findall("float"):
            name = f.get("name")
            if name in ("scale_u", "scale_v"):
                setattr(self, name, get(f, "value"))

    def __repr__(self):
        return f"<Texture '{self.id}' tag={self.tag} {self.w}x{self.h}>"


def _shelf_pack(sizes, bin_size):
    """First-fit decreasing-height shelf packing. sizes: [(w, h, idx)].
    Returns {idx: (x, y)} or None if it does not fit."""
    order = sorted(sizes, key=lambda s: -s[1])
    x = y = shelf_h = 0
    placed = {}
    for w, h, idx in order:
        if w > bin_size or h > bin_size:
            return None
        if x + w > bin_size:              # new shelf
            y += shelf_h
            x = shelf_h = 0
        if y + h > bin_size:
            return None
        placed[idx] = (x, y)
        x += w
        shelf_h = max(shelf_h, h)
    return placed


def image_packer(textures):
    """Pack image textures of one tag into a square atlas; write offsets back.

    Returns (atlas_image float32 (S,S,3) or None, {id: TextureRec})."""
    rects = [(t.w, t.h, i) for i, t in enumerate(textures)
             if t.mode == MODE_IMAGE]
    result = {t.id: t for t in textures}
    if not rects:
        return None, result
    for size in ATLAS_SIZES:
        placed = _shelf_pack(rects, size)
        if placed is not None:
            atlas = np.zeros((size, size, 3), dtype=np.float32)
            for idx, (x, y) in placed.items():
                t = textures[idx]
                t.off_x, t.off_y = x, y
                atlas[y:y + t.h, x:x + t.w] = t.texture_img
            return atlas, result
    raise ValueError("Texture packing failed even at the largest atlas size")


def parse_textures(texture_nodes):
    """Group <texture> nodes by tag and pack each group
    (reference xml_parser.py:196-216). Returns (images, records) dicts."""
    if not texture_nodes:
        return None, None
    groups = {"albedo": [], "normal": [], "bump": [], "roughness": []}
    for node in texture_nodes:
        groups[node.get("tag", "albedo")].append(TextureRec(node))
    packed_imgs, packed_recs = {}, {}
    for key, texs in groups.items():
        img, recs = image_packer(texs) if texs else (None, None)
        packed_imgs[key] = img
        packed_recs[key] = recs
    return packed_imgs, packed_recs
