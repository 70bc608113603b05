"""Device-side dynamic scene updates: per-frame transform and activity
changes without a host recompile — the port of ``hikari_tpu.scene.update``.

The reference rebuilds TLAS / emissive BVH / alias tables incrementally on
ECS change events every frame (src/mesh_material/instance.rs:130-175,
244-444) and keeps a per-entity two-frame transform queue
(src/transform.rs:32-44). Here new per-instance model matrices are
ordinary tensors on the scene's device, and

  * world triangles are re-transformed from the local-space copy,
  * vertex normals are re-transformed by the inverse-transpose,
  * the stitched TLAS+BLAS node graph is REFIT bottom-up (fixed topology;
    AABBs recomputed leaves-up in ``refit_depth`` parallel sweeps over the
    child arrays),
  * instance AABBs, emissive bounding spheres and surface areas are
    recomputed, and the emissive BVH is refit the same way,
  * ``inst_prev_model`` takes the old transforms (the transform-history
    queue), feeding motion vectors.

Every step is a tensor operation on the scene's device: an update makes
no host sync, and the result has the same shapes, dtypes and device.

Alias tables are not updated here: triangle-area proportions only change
when an instance's linear part changes, so — matching the reference's
cache-by-scale (instance.rs:386-400) — the host ``SceneUpdater`` rebuilds
an instance's alias rows only on a change of its linear part.

``HikariUniversalSettings``' build toggles (src/lib.rs:375-389) gate the
two refit halves as they gate the reference's BVH builds:
``build_mesh_acceleration_structure`` pins BLAS-node AABBs and
``build_instance_acceleration_structure`` pins TLAS-node AABBs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hikari_tpu_torch.config import F32_MAX, UniversalSettings
from hikari_tpu_torch.scene.buffers import SceneBuffers
from hikari_tpu_torch.trace.intersect import precompute_triangles


def _apply_affine_planes(m16, inst_idx, x, y, z):
    """World = M @ local for per-element instance transforms, in planes.
    m16: (I, 16) row-major 4x4; inst_idx/x/y/z: (...,). Returns (X, Y, Z)."""
    m = m16[inst_idx]

    def row(r):
        return m[..., 4 * r] * x + m[..., 4 * r + 1] * y + m[..., 4 * r + 2] * z + m[..., 4 * r + 3]

    return row(0), row(1), row(2)


def _apply_linear_planes(m9, inst_idx, x, y, z):
    """(X,Y,Z) = M3 @ (x,y,z) in planes; m9: (I, 9) row-major 3x3."""
    m = m9[inst_idx]

    def row(r):
        return m[..., 3 * r] * x + m[..., 3 * r + 1] * y + m[..., 3 * r + 2] * z

    return row(0), row(1), row(2)


def _refit_planes(leaf_vals, leaf_mask, left, right, old_vals, pinned, depth, is_min):
    """Bottom-up AABB refit of (N, 3) bounds.

    ``leaf_vals``/``old_vals``: (N, 3); ``pinned``: (N,) bool — nodes whose
    AABB keeps its old value (UniversalSettings gating). Each sweep
    recomputes every internal node from its children in parallel; after
    ``depth`` sweeps the values are exact. The three planes share each
    sweep's child gathers (min and max are exact, so this equals the JAX
    package's plane-by-plane sweeps)."""
    has_l = (left >= 0)[:, None]
    has_r = (right >= 0)[:, None]
    l = left.clamp(min=0).long()
    r = right.clamp(min=0).long()
    combine = torch.minimum if is_min else torch.maximum
    leaf = leaf_mask[:, None]
    pin = pinned[:, None]
    p = torch.where(pin, old_vals, torch.where(leaf, leaf_vals, old_vals))
    for _ in range(depth):
        lv, rv = p[l], p[r]
        cv = torch.where(has_r, combine(lv, rv), lv)
        v = torch.where(leaf, leaf_vals, torch.where(has_l, cv, p))
        p = torch.where(pin, old_vals, v)
    return p


def _segment_reduce(values, seg, num_segments, reduce):
    """``jax.ops.segment_{min,max,sum}(values, seg, num_segments)`` over
    axis 0 (``seg`` (P,) in [0, num_segments)): an empty segment holds the
    reduction's identity (+inf for min, -inf for max, 0 for sum), as in
    JAX."""
    init = {"amin": float("inf"), "amax": float("-inf"), "sum": 0.0}[reduce]
    out = torch.full((num_segments,) + values.shape[1:], init, dtype=values.dtype,
                     device=values.device)
    index = seg.long().reshape((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    return out.scatter_reduce_(0, index, values, reduce, include_self=True)


def update_transforms(
    scene: SceneBuffers,
    models,
    prev_models=None,
    universal: UniversalSettings = UniversalSettings(),
) -> SceneBuffers:
    """Return a SceneBuffers with new per-instance transforms applied —
    same shapes, dtypes and device. ``models``: (num_instances, 4, 4)
    (a tensor or anything ``torch.as_tensor`` takes). ``prev_models``
    defaults to the scene's current transforms (the two-frame history
    queue, reference src/transform.rs:32-44)."""
    I = scene.num_instances
    P = scene.tri_world.shape[0]
    dev = scene.device
    models = torch.as_tensor(models, dtype=torch.float32, device=dev).reshape(I, 4, 4)
    prev = scene.inst_model if prev_models is None else torch.as_tensor(
        prev_models, dtype=torch.float32, device=dev).reshape(I, 4, 4)
    # Computed in f64 and rounded, so the card and the CPU give the same
    # f32 inverse (its last bits move the motion vectors); inv_ex: no
    # singularity check, no host sync.
    inv = torch.linalg.inv_ex(models.double()).inverse.float()
    m16 = models.reshape(I, 16)

    # ---- world triangles from local ----
    ti = scene.tri_inst.clamp(min=0).long()
    tl = scene.tri_local
    verts = [_apply_affine_planes(m16, ti, tl[:, k, 0], tl[:, k, 1], tl[:, k, 2])
             for k in range(3)]
    tri_world = torch.stack([torch.stack(v, dim=-1) for v in verts], dim=1)  # (P, 3, 3)
    pre = precompute_triangles(tri_world)

    # ---- vertex normals: inverse-transpose, normalized ----
    vi = scene.vert_inst.clamp(min=0).long()
    nrm9 = inv[:, :3, :3].transpose(1, 2).reshape(I, 9)
    nl = scene.vert_normal_local
    NX, NY, NZ = _apply_linear_planes(nrm9, vi, nl[:, 0], nl[:, 1], nl[:, 2])
    nlen = torch.sqrt(torch.clamp(NX * NX + NY * NY + NZ * NZ, min=1e-24))
    vert_normal = torch.stack([NX / nlen, NY / nlen, NZ / nlen], dim=-1)

    # ---- instance activity (streaming/visibility mask) ----
    # Inactive instances trace/shade/sample as if absent: their triangles
    # are invalid, their AABBs are EMPTY boxes (min=+MAX, max=-MAX —
    # neutral under the min/max refit and segment reduces, so bounds
    # collapse and traversal skips them), their areas are 0, and their
    # emissive spheres are parked at 1e30 with radius 0 (never contain a
    # shading point, never picked by the light walk).
    active_tri = scene.inst_active[ti] & (scene.tri_inst >= 0)

    # ---- triangle AABB planes ----
    act = active_tri[:, None]
    tmin = torch.where(act, tri_world.amin(dim=1), F32_MAX)  # (P, 3)
    tmax = torch.where(act, tri_world.amax(dim=1), -F32_MAX)

    # ---- instance AABBs (segment reduce; padded tris -> segment I, dropped)
    seg = torch.where(scene.tri_inst >= 0, scene.tri_inst, I)
    inst_min = _segment_reduce(tmin, seg, I + 1, "amin")[:I]
    inst_max = _segment_reduce(tmax, seg, I + 1, "amax")[:I]

    # ---- stitched-graph refit ----
    node_min, node_max = scene.node_min, scene.node_max
    if (universal.build_mesh_acceleration_structure
            or universal.build_instance_acceleration_structure):
        N = scene.node_entry.shape[0]
        leaf_mask = scene.node_entry < 0
        safe_prim = torch.clamp(-scene.node_entry - 1, 0, P - 1).long()
        is_tlas = torch.arange(N, device=dev) < scene.num_tlas_nodes
        pinned = torch.zeros(N, dtype=torch.bool, device=dev)
        if not universal.build_mesh_acceleration_structure:
            pinned = pinned | ~is_tlas
        if not universal.build_instance_acceleration_structure:
            pinned = pinned | is_tlas
        node_min = _refit_planes(tmin[safe_prim], leaf_mask, scene.node_left, scene.node_right,
                                 scene.node_min, pinned, scene.refit_depth, is_min=True)
        node_max = _refit_planes(tmax[safe_prim], leaf_mask, scene.node_left, scene.node_right,
                                 scene.node_max, pinned, scene.refit_depth, is_min=False)

    # ---- emissives: spheres + surface areas + light-BVH refit ----
    em_position, em_radius = scene.em_position, scene.em_radius
    em_surface_area = scene.em_surface_area
    enode_min, enode_max = scene.enode_min, scene.enode_max
    if scene.num_emissives > 0:
        # Per-triangle world areas (0.5 |e1 x e2|) in planes.
        wx, wy, wz = (tri_world[..., c] for c in range(3))
        txyz = [wx, wy, wz]
        e1 = [txyz[c][:, 1] - txyz[c][:, 0] for c in range(3)]
        e2 = [txyz[c][:, 2] - txyz[c][:, 0] for c in range(3)]
        cxp = e1[1] * e2[2] - e1[2] * e2[1]
        cyp = e1[2] * e2[0] - e1[0] * e2[2]
        czp = e1[0] * e2[1] - e1[1] * e2[0]
        area = torch.where(active_tri, 0.5 * torch.sqrt(cxp * cxp + cyp * cyp + czp * czp), 0.0)
        inst_area = _segment_reduce(area, seg, I + 1, "sum")[:I]

        em_inst = torch.clamp(scene.em_instance, 0, I - 1).long()
        active_em = scene.inst_active[em_inst]  # (E,)
        # Empty boxes of inactive instances are (+MAX, -MAX): guard the
        # center/diag math behind the activity select.
        e_min = torch.where(active_em[:, None], inst_min[em_inst], 0.0)
        e_max = torch.where(active_em[:, None], inst_max[em_inst], 0.0)
        center = 0.5 * (e_min + e_max)  # (E, 3)
        diag = e_max - e_min
        emissive = scene.mat_emissive[scene.inst_material[em_inst].long()]  # (E, 4)
        intensity = 255.0 * emissive[:, 3] * torch.linalg.vector_norm(emissive[:, :3], dim=-1)
        # Bounding sphere: 0.5*diag + sqrt(intensity)
        # (reference instance.rs:408-418).
        radius = 0.5 * torch.linalg.vector_norm(diag, dim=-1) + torch.sqrt(
            torch.clamp(intensity, min=0.0))
        em_position = torch.where(active_em[:, None], center, 1e30)
        em_radius = torch.where(active_em, radius, 0.0)
        em_surface_area = inst_area[em_inst]

        EN = scene.enode_entry.shape[0]
        eleaf = scene.enode_entry < 0
        safe_em = torch.clamp(-scene.enode_entry - 1, 0, scene.num_emissives - 1).long()
        s_min = center - radius[:, None]
        s_max = center + radius[:, None]
        no_pin = torch.zeros(EN, dtype=torch.bool, device=dev)
        enode_min = _refit_planes(s_min[safe_em], eleaf, scene.enode_left, scene.enode_right,
                                  scene.enode_min, no_pin, scene.erefit_depth, is_min=True)
        enode_max = _refit_planes(s_max[safe_em], eleaf, scene.enode_left, scene.enode_right,
                                  scene.enode_max, no_pin, scene.erefit_depth, is_min=False)

    return dataclasses.replace(
        scene,
        tri_world=tri_world,
        tri_n=pre["n"],
        tri_eu=pre["eu"],
        tri_ev=pre["ev"],
        tri_cn=pre["cn"],
        tri_cu=pre["cu"],
        tri_cv=pre["cv"],
        tri_valid=pre["valid"] & active_tri,
        vert_normal=vert_normal,
        node_min=node_min,
        node_max=node_max,
        inst_min=inst_min,
        inst_max=inst_max,
        inst_model=models,
        inst_prev_model=prev,
        inst_inv_model=inv,
        em_position=em_position,
        em_radius=em_radius,
        em_surface_area=em_surface_area,
        enode_min=enode_min,
        enode_max=enode_max,
    )


def update_activity(
    scene: SceneBuffers,
    active,
    universal: UniversalSettings = UniversalSettings(),
) -> SceneBuffers:
    """Toggle per-instance visibility / streaming state on the device — the
    analogue of the reference's asset streaming (city.rs:23 loads models
    in over time; instance.rs:269-283 retries unready assets) and
    visibility change events (instance.rs:130-175). Instances are
    pre-declared at compile time; flipping ``active`` masks triangles,
    collapses the instance's AABBs out of the BVHs (refit), zeroes its
    surface areas and parks its emissive sphere — same shapes, no
    recompile. ``active``: (num_instances,) bool."""
    scene = dataclasses.replace(
        scene, inst_active=torch.as_tensor(active, device=scene.device).to(torch.bool))
    # Re-derive every activity-dependent tensor through the transform
    # update at unchanged transforms (history preserved).
    return update_transforms(scene, scene.inst_model, prev_models=scene.inst_prev_model,
                             universal=universal)


class SceneUpdater:
    """Host-side orchestration of dynamic updates — the analogue of the
    reference's change-event systems (instance_event_system,
    src/mesh_material/instance.rs:130-175).

    Holds the host Scene + device SceneBuffers; ``set_transforms`` runs
    ``update_transforms`` and, matching the reference's alias-table cache
    keyed by transform scale (instance.rs:386-400), rebuilds an emissive
    instance's alias rows on the host ONLY when its linear part changed.
    Material edits (``set_material``) re-upload the small material
    tensors; emissive-set membership changes still need a full
    ``compile_scene`` (the reference likewise rebuilds on asset events).
    """

    def __init__(self, scene, buffers: SceneBuffers,
                 universal: UniversalSettings = UniversalSettings()):
        self.scene = scene
        self.buffers = buffers
        self.universal = universal
        self._linear_cache = {
            i: np.asarray(inst.transform[:3, :3]).copy()
            for i, inst in enumerate(scene.instances)
        }
        # instance id -> emissive slot (for alias rebuilds)
        self._em_slot = {
            int(e): k for k, e in enumerate(buffers.em_instance.cpu().numpy())
            if int(e) >= 0 and k < buffers.num_emissives
        }

    def set_transforms(self, new_models: dict[int, np.ndarray] | np.ndarray):
        """Apply new transforms. ``new_models``: full (I,4,4) array or a
        sparse {instance_id: 4x4} dict. Returns the updated buffers."""
        models = self.buffers.inst_model.cpu().numpy().copy()
        if isinstance(new_models, dict):
            for i, m in new_models.items():
                models[i] = np.asarray(m, dtype=np.float32)
        else:
            models = np.asarray(new_models, dtype=np.float32)

        self.buffers = update_transforms(self.buffers, models, universal=self.universal)
        self._maybe_rebuild_alias(models)
        for i, inst in enumerate(self.scene.instances):
            inst.previous_transform = inst.transform
            inst.transform = models[i]
        return self.buffers

    def set_active(self, changes: dict[int, bool]):
        """Stream instances in/out: {instance_id: active}. Device-only
        masking via ``update_activity`` — no recompile, no re-upload."""
        active = self.buffers.inst_active.cpu().numpy().copy()
        for i, a in changes.items():
            active[i] = bool(a)
        self.buffers = update_activity(self.buffers, active, universal=self.universal)
        return self.buffers

    def _maybe_rebuild_alias(self, models: np.ndarray):
        from hikari_tpu_torch.scene.alias import build_alias_table

        b = self.buffers
        changed_rows = {}
        for inst_id, slot in self._em_slot.items():
            lin = models[inst_id][:3, :3]
            if np.allclose(lin, self._linear_cache[inst_id], atol=1e-7):
                continue
            self._linear_cache[inst_id] = lin.copy()
            inst = self.scene.instances[inst_id]
            mesh = self.scene.meshes[inst.mesh]
            # triangle_areas is mesh-order; the buffers store triangles in
            # BLAS DFS-leaf order (compile_scene) — permute to match so
            # alias_index keeps meaning instance-local PERMUTED prim ids.
            po = int(b.inst_prim_offset[inst_id])
            pc = int(b.inst_prim_count[inst_id])
            perm = b.tri_mesh_index[po: po + pc].cpu().numpy()
            areas = mesh.triangle_areas(models[inst_id])[perm]
            changed_rows[slot] = build_alias_table(areas)
        if not changed_rows:
            return
        alias_prob = b.alias_prob.cpu().numpy().copy()
        alias_index = b.alias_index.cpu().numpy().copy()
        off = b.em_alias_offset.cpu().numpy()
        cnt = b.em_alias_count.cpu().numpy()
        for slot, (prob, index) in changed_rows.items():
            o, c = int(off[slot]), int(cnt[slot])
            if c != len(prob):
                raise ValueError("alias count changed: rebuild with compile_scene")
            alias_prob[o: o + c] = prob
            alias_index[o: o + c] = index
        self.buffers = dataclasses.replace(
            b,
            alias_prob=torch.from_numpy(alias_prob).to(b.device),
            alias_index=torch.from_numpy(alias_index).to(b.device, b.alias_index.dtype),
        )

    def set_material(self, mat_id: int, **fields):
        """Update material factors in place (the material tensors are
        tiny). Changing emissive INTENSITY is allowed; toggling emissive
        on/off changes the emissive set -> ``ValueError`` (host recompile
        required); an unknown field -> ``KeyError``."""
        mat = self.scene.materials[mat_id]

        def is_emissive():
            return 255.0 * mat.emissive[3] * float(np.linalg.norm(mat.emissive[:3])) > 0.0

        was_emissive = is_emissive()
        for k, v in fields.items():
            setattr(mat, k, v)
        if was_emissive != is_emissive():
            raise ValueError("emissive-set membership changed; rebuild with compile_scene")
        b = self.buffers
        upd = {}
        arrmap = {
            "base_color": "mat_base_color",
            "emissive": "mat_emissive",
            "perceptual_roughness": "mat_perceptual_roughness",
            "metallic": "mat_metallic",
            "reflectance": "mat_reflectance",
        }
        for k in fields:
            if k not in arrmap:
                raise KeyError(f"unsupported dynamic material field {k!r}")
            arr = getattr(b, arrmap[k]).clone()
            arr[mat_id] = torch.as_tensor(np.asarray(fields[k], dtype=np.float32), device=b.device)
            upd[arrmap[k]] = arr
        # The emissive factor feeds the bounding spheres; re-run the update
        # with unchanged transforms to refresh spheres/radii.
        self.buffers = dataclasses.replace(b, **upd)
        if "emissive" in fields:
            self.buffers = update_transforms(self.buffers, self.buffers.inst_model,
                                             universal=self.universal)
        return self.buffers
