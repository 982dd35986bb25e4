# Launch layer (port of ``repro.launch``): the production mesh and the
# rule set for a mesh, the one-card rank layouts of the mesh router, and
# ``serve`` (the LM's prefill, decode step and greedy loop). The AOT
# input specs, the train step and the dry run come with later slices.
