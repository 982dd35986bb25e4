# Launch layer (port of ``repro.launch``): the production mesh and the
# rule set for a mesh, and the one-card rank layouts of the mesh router.
# The AOT input specs, the train/serve steps and the dry run come with
# later slices.
