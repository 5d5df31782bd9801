"""The traffic and the genome, made from seeds: the genome generator (a
frozen copy), the FASTA access that the mapper's N rule needs, and the
read simulator."""
