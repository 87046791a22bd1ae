from .fasta import DnaRecord, read_dna, read_rna, cut_sequence, same_seq  # noqa: F401
