"""``python -m repro_torch.fleet.worker``: the entry point of a fleet's
worker process (implementation: :mod:`repro_torch.fleet.net.worker`)."""
from repro_torch.fleet.net.worker import main

if __name__ == "__main__":
    raise SystemExit(main())
