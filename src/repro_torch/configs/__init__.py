from .base import (ARCH_IDS, SHAPES, SHAPES_BY_NAME, ModelConfig, ShapeConfig,
                   all_cells, cell_runnable, get_config)
