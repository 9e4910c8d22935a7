"""svjedi-tpu: structural-variant genotyping for long reads on the GPU.

A from-scratch JAX re-design of the capabilities of
SandraLouise/SVJedi-graph (reference layout documented in SURVEY.md and
ARCHITECTURE.md). Public entry points:

- :func:`svjedi_tpu.pipeline.run_pipeline` — end-to-end VCF+FASTA+FASTQ → genotyped VCF.
- ``python -m svjedi_tpu`` — CLI with reference-parity flags.
"""

__version__ = "0.1.0"
