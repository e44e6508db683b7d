"""Network roles of the port: wire protocol, registry, ledger, transport,
miner, validator and the in-process mock network."""
