"""Configuration (counterpart of ``p2p_tpu/core/config.py``), cut to the
fields the serving path reads. Field names, defaults and the preset values
are those of the JAX package, so one preset name means one model in both.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # generator family: "pix2pixhd" (coarse-to-fine global + local),
    # "pix2pixhd_global" (G1 alone), "resnet" (9-block ResnetGenerator)
    generator: str = "expand"
    input_nc: int = 3
    output_nc: int = 3
    ngf: int = 32
    n_blocks: int = 9
    # the compression pre-filter; the port serves presets without it
    use_compression_net: bool = True
    # "instance" | "pallas_instance" ("batch" comes with training)
    norm: str = "batch"


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "facades"
    image_size: int = 256
    image_width: Optional[int] = None  # None → square
    batch_size: int = 1
    test_batch_size: int = 1
    # requests travel host → device as uint8 and are normalized on the
    # device (utils/images.ingest)
    uint8_pipeline: bool = True


@dataclasses.dataclass(frozen=True)
class Config:
    name: str = "default"
    model: ModelConfig = ModelConfig()
    data: DataConfig = DataConfig()

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def image_hw(self) -> Tuple[int, int]:
        h = self.data.image_size
        w = self.data.image_width or h
        return h, w


_PRESETS = {}


def _register(cfg: Config) -> Config:
    _PRESETS[cfg.name] = cfg
    return cfg


# pix2pixHD coarse-to-fine G at 1024×512, fused instance-norm epilogues
_register(
    Config(
        name="pix2pixhd",
        model=ModelConfig(generator="pix2pixhd", ngf=64,
                          norm="pallas_instance", use_compression_net=False),
        data=DataConfig(dataset="cityscapes_hd", image_size=512,
                        image_width=1024, batch_size=1),
    )
)


def get_preset(name: str) -> Config:
    try:
        return _PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; have {sorted(_PRESETS)}"
                       ) from None
