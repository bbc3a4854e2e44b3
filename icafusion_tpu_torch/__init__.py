"""PyTorch/CUDA port of icafusion_tpu for NVIDIA Hopper (H100).

The serving path of the two-stream ICAFusion detector: paired RGB+IR images
-> two CSPDarknet towers -> TransformerFusionBlocks (dual cross-attention)
-> PANet head -> Detect decode -> batched greedy NMS. The two TPU kernels of
that path (dual cross-attention, greedy NMS) are hand-written CUDA C++ in
``csrc/``, built with ``nvcc`` at first use and bound with ``ctypes``
(``kernels/_build.py``).

This package imports torch only: never jax, flax or ``icafusion_tpu``.
"""

__version__ = "0.1.0"

from icafusion_tpu_torch.config import (load_data_config,  # noqa: E402
                                        load_hyp_config, load_model_config)

__all__ = ["load_model_config", "load_data_config", "load_hyp_config",
           "__version__"]
