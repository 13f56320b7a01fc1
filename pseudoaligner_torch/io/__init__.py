from .fasta import read_transcripts, detect_fasta_format, extract_tx_gene_id
from .fastq import FastqReader, read_fastq_records

__all__ = [
    "read_transcripts",
    "detect_fasta_format",
    "extract_tx_gene_id",
    "FastqReader",
    "read_fastq_records",
]
