from .maple_format import read_maple_alignment, read_reference_fasta  # noqa: F401
