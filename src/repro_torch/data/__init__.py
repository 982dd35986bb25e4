# Seeded vector data (port of ``repro.data``); ``TokenPipeline`` comes
# with the slice that ports ``data/pipeline``.
from repro_torch.data.vectors import clustered_vectors, query_set
