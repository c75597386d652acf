"""Dataset generator: the SIGNeRF edit (reference sheet, per-view
splice-and-inpaint, dataset merge, transforms.json)."""

from signerf_tpu_torch.generator.datasetgenerator import (
    DatasetGenerator,
    DatasetGeneratorConfig,
    RendererConfig,
)

__all__ = ["DatasetGenerator", "DatasetGeneratorConfig", "RendererConfig"]
