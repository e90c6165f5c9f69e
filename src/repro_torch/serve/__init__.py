"""Serving stack: scheduler (policy), arch (cache discipline), swap
(ledger) and engine (mechanism) over one ``repro_torch.mem.Arena``."""
