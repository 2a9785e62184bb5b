"""Architecture registry: importing this package registers all configs."""
from repro_torch.configs import (command_r_35b, command_r_plus_104b,
                                 deepseek_v2_236b, h2o_danube_1_8b,
                                 internvl2_2b, llama4_maverick_400b,
                                 mamba2_370m, musicgen_medium, qwen2_5_14b,
                                 zamba2_2_7b)
from repro_torch.configs.base import (ALL_SHAPES, REGISTRY, SHAPES,
                                      ModelConfig, ShapeSpec, get_config,
                                      shapes_for)

ARCH_NAMES = sorted(REGISTRY)
