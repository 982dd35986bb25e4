# Seeded token and vector data (port of ``repro.data``, numpy copies).
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.data.vectors import clustered_vectors, query_set
