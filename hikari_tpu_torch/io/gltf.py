"""Minimal glTF 2.0 (.glb / .gltf) loader -> Scene — the port of
``hikari_tpu.io.gltf`` (the role of Bevy's glTF asset pipeline feeding the
reference's scene compile, examples/cornell.rs:39-42, examples/scene.rs:78-81).

Supports binary GLB and JSON glTF with external .bin or data-URI buffers,
node hierarchies with TRS or matrix transforms, indexed and unindexed
triangle-list and triangle-strip primitives, pbrMetallicRoughness materials
with textures (decoded with PIL) and KHR_materials_emissive_strength. An
image that cannot be decoded gives texture id -1, as in the JAX package.
"""

from __future__ import annotations

import base64
import json
import os
import struct
from io import BytesIO

import numpy as np

from hikari_tpu_torch.scene.compile import Instance, Material, Scene
from hikari_tpu_torch.scene.mesh import Mesh

_COMPONENT_DTYPE = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNT = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _load_chunks(path: str) -> tuple[dict, list[bytes]]:
    """(the glTF JSON, its buffers' bytes) of a .glb or .gltf file."""
    with open(path, "rb") as f:
        data = f.read()
    base_dir = os.path.dirname(path)
    if data[:4] != b"glTF":
        gltf = json.loads(data)
        return gltf, _resolve_buffers(gltf, base_dir, b"")
    _, _, length = struct.unpack_from("<III", data, 0)
    off, gltf, bin_chunk = 12, None, b""
    while off < length:
        clen, ctype = struct.unpack_from("<II", data, off)
        chunk = data[off + 8 : off + 8 + clen]
        off += 8 + clen
        if ctype == 0x4E4F534A:  # JSON
            gltf = json.loads(chunk)
        elif ctype == 0x004E4942:  # BIN
            bin_chunk = chunk
    return gltf, _resolve_buffers(gltf, base_dir, bin_chunk)


def _resolve_buffers(gltf: dict, base_dir: str, bin_chunk: bytes) -> list[bytes]:
    out = []
    for buf in gltf.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            out.append(bin_chunk)
        elif uri.startswith("data:"):
            out.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                out.append(f.read())
    return out


def _read_accessor(gltf: dict, buffers: list[bytes], idx: int) -> np.ndarray:
    acc = gltf["accessors"][idx]
    view = gltf["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT_DTYPE[acc["componentType"]]
    ncomp = _TYPE_COUNT[acc["type"]]
    count = acc["count"]
    itemsize = np.dtype(dtype).itemsize * ncomp
    stride = view.get("byteStride", itemsize)
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    raw = buffers[view["buffer"]]
    if stride == itemsize:
        arr = np.frombuffer(raw, dtype=dtype, count=count * ncomp, offset=offset)
    else:
        arr = np.concatenate([
            np.frombuffer(raw, dtype=dtype, count=ncomp, offset=offset + i * stride)
            for i in range(count)
        ])
    return arr.reshape(count, ncomp) if ncomp > 1 else arr


def _node_matrix(node: dict) -> np.ndarray:
    """A node's local 4x4 transform: its column-major ``matrix``, else
    translation * rotation (quaternion x, y, z, w) * scale."""
    if "matrix" in node:
        return np.asarray(node["matrix"], dtype=np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    x, y, z, w = node.get("rotation", [0, 0, 0, 1])
    rot = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float32,
    )
    m[:3, :3] = rot * np.asarray(node.get("scale", [1, 1, 1]), dtype=np.float32)[None, :]
    m[:3, 3] = node.get("translation", [0, 0, 0])
    return m


def _convert_material(gmat: dict, tex_id) -> Material:
    pbr = gmat.get("pbrMetallicRoughness", {})
    strength = (
        gmat.get("extensions", {})
        .get("KHR_materials_emissive_strength", {})
        .get("emissiveStrength", 1.0)
    )
    # Bevy maps emissiveFactor to StandardMaterial.emissive with alpha 1;
    # the reference's radiance scale is 255 * a * rgb (light.wgsl:594-596).
    emissive = (*[c * strength for c in gmat.get("emissiveFactor", [0, 0, 0])], 1.0)

    def slot(info):
        return tex_id(info["index"]) if info is not None else -1

    return Material(
        base_color=tuple(pbr.get("baseColorFactor", [1, 1, 1, 1])),
        emissive=emissive,
        perceptual_roughness=pbr.get("roughnessFactor", 1.0),
        metallic=pbr.get("metallicFactor", 1.0),
        reflectance=0.5,
        base_color_texture=slot(pbr.get("baseColorTexture")),
        emissive_texture=slot(gmat.get("emissiveTexture")),
        metallic_roughness_texture=slot(pbr.get("metallicRoughnessTexture")),
        normal_map_texture=slot(gmat.get("normalTexture")),
        occlusion_texture=slot(gmat.get("occlusionTexture")),
    )


def _decode_image(gltf: dict, buffers: list[bytes], base_dir: str, gltf_texture_idx: int):
    """The RGBA8 pixels of a glTF texture's image (PIL)."""
    from PIL import Image

    img = gltf["images"][gltf["textures"][gltf_texture_idx].get("source")]
    if "bufferView" in img:
        view = gltf["bufferViews"][img["bufferView"]]
        off = view.get("byteOffset", 0)
        pil = Image.open(BytesIO(buffers[view["buffer"]][off : off + view["byteLength"]]))
    elif "uri" in img and not img["uri"].startswith("data:"):
        pil = Image.open(os.path.join(base_dir, img["uri"]))
    elif "uri" in img:
        pil = Image.open(BytesIO(base64.b64decode(img["uri"].split(",", 1)[1])))
    else:
        raise ValueError("image without source")
    return np.asarray(pil.convert("RGBA"))


def load_gltf(path: str, scene: Scene | None = None) -> Scene:
    """Load a .glb/.gltf file, appending its default scene into ``scene``."""
    gltf, buffers = _load_chunks(path)
    out = scene if scene is not None else Scene(materials=[])
    base_dir = os.path.dirname(path)
    mat_ids: dict = {}
    tex_cache: dict[int, int] = {}

    def tex_id(gltf_texture_idx: int) -> int:
        """glTF texture index -> scene texture id (decoded once); -1 for an
        image that cannot be decoded, like the reference's fallback image
        (src/lib.rs:528-534)."""
        if gltf_texture_idx not in tex_cache:
            try:
                tid = out.add_texture(_decode_image(gltf, buffers, base_dir, gltf_texture_idx))
            except Exception:
                tid = -1
            tex_cache[gltf_texture_idx] = tid
        return tex_cache[gltf_texture_idx]

    def material_id(idx: int | None) -> int:
        if idx not in mat_ids:
            mat = _convert_material(gltf["materials"][idx], tex_id) if idx is not None else Material()
            mat_ids[idx] = out.add_material(mat)
        return mat_ids[idx]

    # (mesh, primitive) -> (scene mesh id, material id): each glTF
    # primitive is one Mesh.
    prim_cache: dict[tuple[int, int], tuple[int, int]] = {}

    def mesh_prims(mesh_idx: int) -> list[tuple[int, int]]:
        prims = []
        for pi, prim in enumerate(gltf["meshes"][mesh_idx]["primitives"]):
            key = (mesh_idx, pi)
            if key not in prim_cache:
                attrs = prim["attributes"]
                pos = _read_accessor(gltf, buffers, attrs["POSITION"]).astype(np.float32)
                nrm = (_read_accessor(gltf, buffers, attrs["NORMAL"]).astype(np.float32)
                       if "NORMAL" in attrs else np.zeros_like(pos))
                uv = (_read_accessor(gltf, buffers, attrs["TEXCOORD_0"]).astype(np.float32)
                      if "TEXCOORD_0" in attrs else np.zeros((len(pos), 2), dtype=np.float32))
                idx = (_read_accessor(gltf, buffers, prim["indices"]).astype(np.int32)
                       if "indices" in prim else np.arange(len(pos), dtype=np.int32))
                mode = prim.get("mode", 4)  # 4 = TRIANGLES, 5 = TRIANGLE_STRIP
                if mode == 5:
                    # Alternating-winding strips, as GpuMesh::try_from's
                    # TriangleStrip arm (src/mesh_material/mod.rs:433-452).
                    mesh = Mesh.from_triangle_strip(pos, nrm, uv, idx.reshape(-1))
                elif mode == 4:
                    mesh = Mesh(pos, nrm, uv, idx.reshape(-1, 3))
                else:
                    # IncompatiblePrimitiveTopology (mod.rs:451)
                    raise ValueError(f"unsupported glTF primitive mode {mode}")
                prim_cache[key] = (out.add_mesh(mesh), material_id(prim.get("material")))
            prims.append(prim_cache[key])
        return prims

    def walk(node_idx: int, parent: np.ndarray):
        node = gltf["nodes"][node_idx]
        m = parent @ _node_matrix(node)
        if "mesh" in node:
            for mesh_id, mat_id in mesh_prims(node["mesh"]):
                out.add_instance(Instance(mesh=mesh_id, material=mat_id, transform=m))
        for child in node.get("children", []):
            walk(child, m)

    for root in gltf["scenes"][gltf.get("scene", 0)]["nodes"]:
        walk(root, np.eye(4, dtype=np.float32))
    return out


def _png_bytes(rgba: np.ndarray) -> bytes:
    from PIL import Image

    buf = BytesIO()
    Image.fromarray(rgba, "RGBA").save(buf, format="PNG")
    return buf.getvalue()


def write_textured_demo(path: str) -> str:
    """Write a small textured glTF scene to ``path`` (a .gltf, its
    external .bin beside it and PNG textures) and return ``path``: a
    16x16-quad floor with a checker base-color texture (an external PNG),
    a box with metallic-roughness (a data-URI PNG) and occlusion (a PNG
    in the .bin) textures under a matrix-transformed node, and a quad
    with an emissive texture as a triangle strip. 526 triangles, sized for
    the FlightHelmet's camera in ``scene_config``; every loader path of
    ``load_gltf`` is exercised.

    The root node lowers the scene so the floor lies at y = -0.125, off
    the origin: a reservoir without a sample keeps its sample position at
    the origin, and spatial reuse's backface test of such a neighbour seen
    from a floor through the origin is the sign of a rounding error."""
    from hikari_tpu_torch.scene.mesh import cube_mesh

    base = os.path.splitext(os.path.basename(path))[0]
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)

    n = 16  # floor quads per side: 2 n^2 = 512 triangles
    g = np.linspace(-1.0, 1.0, n + 1, dtype=np.float32)
    gx, gz = np.meshgrid(g, g, indexing="xy")
    floor_pos = np.stack([gx, np.zeros_like(gx), gz], -1).reshape(-1, 3)
    floor_nrm = np.tile(np.array([0, 1, 0], np.float32), (len(floor_pos), 1))
    floor_uv = (np.stack([gx, gz], -1).reshape(-1, 2) + 1.0) * 2.0  # 4 repeats
    q = np.arange(n * n)
    v0 = (q // n) * (n + 1) + q % n
    floor_idx = np.stack([v0, v0 + n + 1, v0 + 1, v0 + 1, v0 + n + 1, v0 + n + 2], -1)
    box = cube_mesh(1.0)
    quad_pos = np.array([[-0.5, 0, 0], [0.5, 0, 0], [-0.5, 1, 0], [0.5, 1, 0]], np.float32)
    quad_nrm = np.tile(np.array([0, 0, 1], np.float32), (4, 1))
    quad_uv = np.array([[0, 1], [1, 1], [0, 0], [1, 0]], np.float32)

    yy, xx = np.mgrid[0:16, 0:16]
    checker = np.where(((yy // 4 + xx // 4) % 2)[..., None] == 0,
                       np.array([230, 220, 200, 255], np.uint8), np.array([40, 60, 140, 255], np.uint8))
    mr = np.stack([xx * 16, yy * 16, 255 - xx * 16, np.full_like(xx, 255)], -1).astype(np.uint8)
    occ = np.stack([128 + yy * 8] * 3 + [np.full_like(yy, 255)], -1).astype(np.uint8)
    emi = np.stack([255 - yy * 12, 64 + xx * 12, np.full_like(xx, 96), np.full_like(xx, 255)],
                   -1).astype(np.uint8)
    with open(os.path.join(directory, f"{base}_checker.png"), "wb") as f:
        f.write(_png_bytes(checker))
    with open(os.path.join(directory, f"{base}_emissive.png"), "wb") as f:
        f.write(_png_bytes(emi))

    blob, views, accessors = bytearray(), [], []

    def add(arr, gltf_type, target=None, count_as_image=False):
        while len(blob) % 4:
            blob.append(0)
        data = np.ascontiguousarray(arr).tobytes()
        view = {"buffer": 0, "byteOffset": len(blob), "byteLength": len(data)}
        if target is not None:
            view["target"] = target
        blob.extend(data)
        views.append(view)
        if count_as_image:
            return len(views) - 1
        comp = {np.dtype(np.float32): 5126, np.dtype(np.uint32): 5125, np.dtype(np.uint16): 5123}
        acc = {"bufferView": len(views) - 1, "componentType": comp[arr.dtype],
               "count": len(arr), "type": gltf_type}
        if gltf_type == "VEC3" and arr.dtype == np.float32:
            acc["min"], acc["max"] = arr.min(0).tolist(), arr.max(0).tolist()
        accessors.append(acc)
        return len(accessors) - 1

    def prim(pos, nrm, uv, idx, material, mode=4):
        p = {"attributes": {"POSITION": add(pos, "VEC3", 34962), "NORMAL": add(nrm, "VEC3", 34962),
                            "TEXCOORD_0": add(uv, "VEC2", 34962)},
             "material": material, "mode": mode}
        if idx is not None:
            p["indices"] = add(idx, "SCALAR", 34963)
        return p

    meshes = [
        {"primitives": [prim(floor_pos, floor_nrm, floor_uv.astype(np.float32),
                             floor_idx.reshape(-1).astype(np.uint32), 0)]},
        {"primitives": [prim(box.positions, box.normals, box.uvs,
                             box.indices.reshape(-1).astype(np.uint16), 1)]},
        {"primitives": [prim(quad_pos, quad_nrm, quad_uv, None, 2, mode=5)]},
    ]
    occ_view = add(np.frombuffer(_png_bytes(occ), np.uint8), None, count_as_image=True)
    with open(os.path.join(directory, f"{base}.bin"), "wb") as f:
        f.write(bytes(blob))
    mr_uri = "data:image/png;base64," + base64.b64encode(_png_bytes(mr)).decode()
    gltf = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [
            {"children": [1, 2, 3], "translation": [0.0, -0.125, 0.0]},
            {"mesh": 0, "scale": [0.9, 1.0, 0.9]},
            {"mesh": 1, "matrix": [0.35, 0, 0, 0, 0, 0.35, 0, 0, 0, 0, 0.35, 0, 0.05, 0.18, 0.1, 1]},
            {"mesh": 2, "translation": [-0.35, 0.05, -0.45], "rotation": [0.0, 0.3826834, 0.0, 0.9238795],
             "scale": [0.5, 0.5, 0.5]},
        ],
        "meshes": meshes,
        "materials": [
            {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}, "metallicFactor": 0.0,
                                      "roughnessFactor": 0.8}},
            {"pbrMetallicRoughness": {"baseColorFactor": [0.8, 0.5, 0.3, 1.0],
                                      "metallicRoughnessTexture": {"index": 1},
                                      "metallicFactor": 0.7, "roughnessFactor": 0.4},
             "occlusionTexture": {"index": 2}},
            {"pbrMetallicRoughness": {"baseColorFactor": [1, 1, 1, 1]},
             "emissiveTexture": {"index": 3}, "emissiveFactor": [1.0, 1.0, 1.0],
             "extensions": {"KHR_materials_emissive_strength": {"emissiveStrength": 0.5}}},
        ],
        "textures": [{"source": 0}, {"source": 1}, {"source": 2}, {"source": 3}],
        "images": [
            {"uri": f"{base}_checker.png"},
            {"uri": mr_uri},
            {"bufferView": occ_view, "mimeType": "image/png"},
            {"uri": f"{base}_emissive.png"},
        ],
        "buffers": [{"uri": f"{base}.bin", "byteLength": len(blob)}],
        "bufferViews": views,
        "accessors": accessors,
    }
    with open(path, "w") as f:
        json.dump(gltf, f)
    return path
