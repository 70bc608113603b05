"""Physically-based BRDF: Burley diffuse + GGX specular + EnvBRDF ambient —
the port of ``hikari_tpu.render.brdf`` (Filament-derived ``bevy_pbr``
lighting, reference light.wgsl:711-908). Pure elementwise math over the
pixel grid."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from hikari_tpu_torch.render.texture import sample_texture_atlas, srgb_to_linear
from hikari_tpu_torch.utils import PI, dot3, safe_normalize, saturate, take_rows


def perceptual_roughness_to_roughness(perceptual_roughness):
    """Clamp + square (bevy_pbr; used at light.wgsl:738)."""
    clamped = torch.clamp(perceptual_roughness, 0.089, 1.0)
    return clamped * clamped


def d_ggx(roughness, noh):
    one_minus = 1.0 - noh * noh
    a = noh * roughness
    k = roughness / (one_minus + a * a)
    return k * k * (1.0 / PI)


def v_smith_ggx_correlated(roughness, nov, nol):
    a2 = roughness * roughness
    lambda_v = nol * torch.sqrt((nov - a2 * nov) * nov + a2)
    lambda_l = nov * torch.sqrt((nol - a2 * nol) * nol + a2)
    return 0.5 / torch.clamp(lambda_v + lambda_l, min=1e-7)


def f_schlick_vec(f0, f90, voh):
    return f0 + (f90[..., None] - f0) * torch.pow(1.0 - voh, 5.0)[..., None]


def f_schlick(f0, f90, voh):
    return f0 + (f90 - f0) * torch.pow(1.0 - voh, 5.0)


def fresnel_f90(f0):
    return saturate((f0 * (50.0 * 0.33)).sum(-1))


def fresnel(f0, loh):
    return f_schlick_vec(f0, fresnel_f90(f0), loh)


def specular(f0, roughness, nov, nol, noh, loh, specular_intensity=1.0):
    """GGX specular lobe (bevy_pbr ``specular``)."""
    d = d_ggx(roughness, noh)
    v = v_smith_ggx_correlated(roughness, nov, nol)
    f = fresnel(f0, loh)
    return (specular_intensity * d * v)[..., None] * f


def fd_burley(roughness, nov, nol, loh):
    """Burley (Disney) diffuse (bevy_pbr ``Fd_Burley``)."""
    f90 = 0.5 + 2.0 * roughness * loh * loh
    light_scatter = f_schlick(1.0, f90, nol)
    view_scatter = f_schlick(1.0, f90, nov)
    return light_scatter * view_scatter * (1.0 / PI)


def env_brdf_approx(f0, perceptual_roughness, nov):
    """Karis mobile EnvBRDF approximation (bevy_pbr ``EnvBRDFApprox``):
    r = pr * c0 + c1 with c0 = (-1, -0.0275, -0.572, 0.022) and
    c1 = (1, 0.0425, 1.04, -0.04), written per component."""
    pr = perceptual_roughness
    r0 = pr * -1.0 + 1.0
    r1 = pr * -0.0275 + 0.0425
    r2 = pr * -0.572 + 1.04
    r3 = pr * 0.022 + -0.04
    a004 = torch.minimum(r0 * r0, torch.exp2(-9.28 * nov)) * r0 + r1
    ab_x = -1.04 * a004 + r2
    ab_y = 1.04 * a004 + r3
    return f0 * ab_x[..., None] + ab_y[..., None]


@dataclass(frozen=True)
class Surface:
    """Reference ``Surface`` (light.wgsl:281-288)."""

    base_color: torch.Tensor  # (..., 4)
    emissive: torch.Tensor  # (..., 4)
    reflectance: torch.Tensor  # (...,)
    metallic: torch.Tensor  # (...,)
    roughness: torch.Tensor  # (...,) already converted from perceptual
    occlusion: torch.Tensor  # (...,)

    def replace_roughness(self, value) -> "Surface":
        return Surface(
            base_color=self.base_color,
            emissive=self.emissive,
            reflectance=self.reflectance,
            metallic=self.metallic,
            roughness=torch.broadcast_to(value, self.roughness.shape),
            occlusion=self.occlusion,
        )


def _textured(scene, uv) -> bool:
    return scene.num_textures > 0 and uv is not None


def _sample(scene, slot, safe, uv):
    """The material's texture in ``slot`` (a per-material id table) at
    ``uv``: white where the material has none."""
    from hikari_tpu_torch.render.texture import sample_texture_atlas

    return sample_texture_atlas(scene.tex_atlas, scene.tex_meta, take_rows(slot, safe), uv)


def _srgb_rgba(c):
    return torch.cat([srgb_to_linear(c[..., :3]), c[..., 3:4]], dim=-1)


def retrieve_surface(scene, material_index, uv=None) -> Surface:
    """Reference ``retreive_surface`` (light.wgsl:730-794).
    ``material_index`` may be -1 (miss): clamped gather, callers mask.
    Without textures (or without ``uv``) this is the NO_TEXTURE
    specialization; otherwise the base-color and emissive textures
    (sRGB -> linear) multiply their factors, metallic takes the
    metallic-roughness texture's red channel (light.wgsl:768) and the
    occlusion texture's red channel is the occlusion. The normal-map slot
    is kept but never sampled, as in the reference."""
    safe = material_index.clamp(min=0)
    packed = torch.cat(
        [
            scene.mat_base_color,
            scene.mat_emissive,
            scene.mat_metallic[:, None],
            scene.mat_reflectance[:, None],
            scene.mat_perceptual_roughness[:, None],
        ],
        dim=-1,
    )
    rows = take_rows(packed, safe)  # (..., 11)
    base_color, emissive = rows[..., 0:4], rows[..., 4:8]
    metallic = rows[..., 8]
    occlusion = torch.ones_like(metallic)
    if _textured(scene, uv):
        base_color = base_color * _srgb_rgba(_sample(scene, scene.mat_base_color_texture, safe, uv))
        emissive = emissive * _srgb_rgba(_sample(scene, scene.mat_emissive_texture, safe, uv))
        metallic = metallic * _sample(scene, scene.mat_metallic_roughness_texture, safe, uv)[..., 0]
        occlusion = _sample(scene, scene.mat_occlusion_texture, safe, uv)[..., 0]
    return Surface(
        base_color=base_color,
        emissive=emissive,
        reflectance=rows[..., 9],
        metallic=metallic,
        roughness=perceptual_roughness_to_roughness(rows[..., 10]),
        occlusion=occlusion,
    )


def retrieve_emissive(scene, material_index, uv=None):
    """Reference ``retreive_emissive`` (light.wgsl:744-747, :783-793)."""
    safe = material_index.clamp(min=0)
    emissive = take_rows(scene.mat_emissive, safe)
    if _textured(scene, uv):
        emissive = emissive * _srgb_rgba(_sample(scene, scene.mat_emissive_texture, safe, uv))
    return emissive


def compute_emissive_radiance(emissive):
    """Radiance scale 255 * a * rgb (reference light.wgsl:594-596)."""
    return 255.0 * emissive[..., 3:4] * emissive[..., :3]


def lit(radiance, diffuse_color, roughness, f0, l, n, v):
    """Direct lighting: Burley diffuse + GGX specular, times NoL
    (reference ``lit``, light.wgsl:796-818)."""
    h = safe_normalize(l + v)
    nol = saturate(dot3(n, l))
    noh = saturate(dot3(n, h))
    loh = saturate(dot3(l, h))
    nov = torch.clamp(dot3(n, v), min=0.0001)
    diffuse = diffuse_color * fd_burley(roughness, nov, nol, loh)[..., None]
    spec = specular(f0, roughness, nov, nol, noh, loh, 1.0)
    return (spec + diffuse) * radiance * nol[..., None]


def ambient(diffuse_color, roughness, occlusion, f0, n, v, ambient_color):
    """Ambient env-BRDF approx (reference ``ambient``, light.wgsl:820-833)."""
    nov = torch.clamp(dot3(n, v), min=0.0001)
    diffuse_ambient = env_brdf_approx(diffuse_color, torch.ones_like(roughness), nov)
    specular_ambient = env_brdf_approx(f0, roughness, nov)
    return occlusion[..., None] * (diffuse_ambient + specular_ambient) * ambient_color


def _f0_diffuse(surface: Surface):
    base_color = surface.base_color[..., :3]
    f0 = (
        0.16 * (surface.reflectance * surface.reflectance * (1.0 - surface.metallic))[..., None]
        + base_color * surface.metallic[..., None]
    )
    return f0, base_color * (1.0 - surface.metallic[..., None])


def shading(v, n, l, surface: Surface, input_radiance, ambient_color):
    """Mix lit vs ambient by input alpha (reference ``shading``,
    light.wgsl:869-888)."""
    f0, diffuse_color = _f0_diffuse(surface)
    lit_radiance = lit(input_radiance[..., :3], diffuse_color, surface.roughness, f0, l, n, v)
    ambient_radiance = ambient(
        diffuse_color, surface.roughness, surface.occlusion, f0, n, v, ambient_color
    )
    a = input_radiance[..., 3:4]
    return lit_radiance * a + ambient_radiance * (1.0 - a)


def shading_factors(v, n, surface: Surface, ambient_color):
    """The factors of ``shading`` that no light direction changes, each
    computed as ``shading`` computes it: (f0, diffuse colour, NoV,
    fresnel's f90, the ambient term)."""
    f0, diffuse_color = _f0_diffuse(surface)
    nov = torch.clamp(dot3(n, v), min=0.0001)
    ambient_radiance = ambient(
        diffuse_color, surface.roughness, surface.occlusion, f0, n, v, ambient_color
    )
    return f0, diffuse_color, nov, fresnel_f90(f0), ambient_radiance


def env_brdf(v, n, surface: Surface):
    """Albedo for demodulation + overlay fallback (reference ``env_brdf``,
    light.wgsl:890-908)."""
    nov = torch.clamp(dot3(n, v), min=0.0001)
    f0, diffuse_color = _f0_diffuse(surface)
    diffuse_ambient = env_brdf_approx(diffuse_color, torch.ones_like(surface.roughness), nov)
    specular_ambient = env_brdf_approx(f0, surface.roughness, nov)
    return surface.occlusion[..., None] * (diffuse_ambient + specular_ambient)


def calculate_view(camera_position, world_position):
    """Perspective view vector (reference ``calculate_view``,
    light.wgsl:714-727)."""
    return safe_normalize(camera_position - world_position)
