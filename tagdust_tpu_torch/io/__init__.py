from .fastq import Read, SeqReader, open_seq_file  # noqa: F401
