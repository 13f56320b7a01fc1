"""The multi-device layer: data-parallel mapping (mesh), the
k-mer-partitioned lookup (sharded_index), multi-process set-up and count
merge (multihost), the exchange behind their collectives (comm) and the
dry run (dryrun)."""
