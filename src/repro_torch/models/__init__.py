"""Model layers of the port: paged attention, blocks, the KV ledger and
pools, and the serving model (``model.Model``)."""
