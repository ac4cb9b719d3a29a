from .tree import PhyloTree  # noqa: F401
