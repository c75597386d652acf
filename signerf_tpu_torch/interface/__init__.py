"""Interface layer: the headless Generation API and the built-in web viewer."""

from signerf_tpu_torch.interface.api import GenerationInterface

__all__ = ["GenerationInterface"]
