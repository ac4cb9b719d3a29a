from .genomelist import (  # noqa: F401
    TYPE_R, TYPE_N, TYPE_O, simplify, shorten, pass_through_branch,
    terminal_node_genome_list,
)
