"""Distribution layer: device mesh, sharded count step, psum merges.

The only cross-read reduction in the whole pipeline is the per-(SV, allele)
support-count matrix (SURVEY §2.2), so scaling is: shard read batches over
the ``data`` mesh axis, shard the SV count space over the ``graph`` axis
(for genomes whose SV table outgrows one device), and ``psum`` the dense
``(n_tags, 2)`` count matrix over both axes. Genotype likelihood afterwards
is embarrassingly parallel.
"""
