"""The SOT / VOS benchmark harness (port of unicorn_tpu/harness/): the
benchmark registry and sequence loaders (`datasets`), the sequence runners
(`running`), OPE success / precision (`analysis`), DAVIS J&F
(`davis_metrics`) and the GOT-10k / TrackingNet submission packers
(`submission`)."""
