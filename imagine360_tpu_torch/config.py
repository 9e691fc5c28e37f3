"""Run configuration (counterpart of imagine360_tpu/config.py): the same
keys as the JAX package's YAML files, which load directly. `from_dict` needs
nothing beyond the standard library; `from_yaml` / `to_yaml` import `yaml`
when called and raise ImportError where it is not installed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class SchedulerSettings:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "linear"
    steps_offset: int = 1
    clip_sample: bool = False
    prediction_type: str = "v_prediction"
    rescale_betas_zero_snr: bool = True


@dataclasses.dataclass
class RunConfig:
    output_dir: str = "outputs"
    # checkpoint paths (cli.build_modules loads those that exist)
    pretrained_model_path: Optional[str] = None       # SD2.1 root (vae, text)
    mvmodel_pretrained_model_path: Optional[str] = None
    pers_unet_pretrained_model_path: Optional[str] = None
    pano_unet_pretrained_model_path: Optional[str] = None
    perslora_motion_module_path: Optional[str] = None
    panolora_motion_module_path: Optional[str] = None
    image_pretrained_model_path: Optional[str] = None  # SAM ViT-B
    lmm_path: Optional[str] = None                     # captioner (optional)
    orbax_cache: Optional[str] = None   # directory of the assembled dual UNet (dual.pt)

    # generation settings
    video_path: str = "examples"
    video_sample_length: int = 32
    lora_alpha_pano: float = 1.0
    lora_alpha_pers: float = 1.0
    pano_H: int = 512
    pano_W: int = 1024
    num_inference_steps: int = 50
    guidance_scale: float = 7.5
    solver: str = "ddim"       # {ddim, dpmpp_2m, dpmpp_2m_sde}

    fps: int = 8
    global_seed: int = 996995
    prompt: str = ""
    negative_prompt: str = "noisy, ugly, nude, watermark"
    # a run with a prompt but no CLIP tokenizer/encoder would silently
    # generate UNCONDITIONED video; the CLI refuses unless this is set
    allow_unconditioned: bool = False
    use_outpaint: bool = True
    angle_adapt: str = "linear_fit"   # {geocalib, perspectivefields, linear_fit, none}
    use_ip_plus_cross_attention: bool = True
    ip_plus_condition: str = "video"
    image_encoder_name: str = "SAM"
    use_fps_condition: bool = True
    antipodal_prob: float = 0.4
    dtype: str = "bfloat16"
    # multi-device (parallel/mesh.py:init_from_config): "off", "auto" (a
    # mesh when torchrun starts several ranks) or "on"; the replica axis,
    # which must divide the world size
    use_mesh: str = "auto"
    mesh_replicas: int = 1

    scheduler: SchedulerSettings = dataclasses.field(default_factory=SchedulerSettings)

    @classmethod
    def from_yaml(cls, path: str) -> "RunConfig":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict) -> "RunConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        sched_fields = {f.name for f in dataclasses.fields(SchedulerSettings)}
        kwargs = {}
        for k, v in raw.items():
            if k in ("noise_scheduler_kwargs", "scheduler"):
                kwargs["scheduler"] = SchedulerSettings(
                    **{kk: vv for kk, vv in v.items() if kk in sched_fields})
            elif k in fields:
                kwargs[k] = v
            # unknown keys (e.g. unet_additional_kwargs) are architectural
            # constants here and intentionally ignored
        return cls(**kwargs)

    def to_yaml(self, path: str):
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(dataclasses.asdict(self), f, sort_keys=False)
