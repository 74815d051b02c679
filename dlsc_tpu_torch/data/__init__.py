"""Data layer of the port: WAV I/O, fold shards, datamodules, the host
prefetcher and the device pipeline."""
