"""Device page pool, byte ledger and admission control."""
