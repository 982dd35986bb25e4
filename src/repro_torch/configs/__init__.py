# Assigned architectures (exact published configs) + reduced smoke
# variants + the paper's own segment workload (port of ``repro.configs``:
# shapes only, no weights). ``get_config(name)`` /
# ``get_smoke_config(name)`` / ``ARCH_IDS`` / shapes in ``shapes.py``.
from repro_torch.configs.registry import (ARCH_IDS, get_config,
                                          get_smoke_config, CONFIGS,
                                          SMOKE_CONFIGS)
from repro_torch.configs.shapes import (SHAPES, Shape, cell_supported,
                                        all_cells, skip_reason)
