r"""Device-agnostic backend layer: the port of jaxmc/backend/__init__.py.

  PLATFORM_RANK       the preference among live platforms.
  BACKEND_CHOICES     what `--backend` accepts.
  oracle              the preflight oracle (backend/oracle.py): probes
                      the candidate platforms with a tiny sort + scatter
                      + search program in a timeout-guarded subprocess,
                      picks the best live one, and stamps the verdict
                      into telemetry (`backend.oracle_choice`).

The reference's BackendDescriptor carries the platform, mesh shape,
donation policy and capacity-profile namespace to its engines.  The
port's engines run on one torch device, update their buffers in place
and keep no capacity profiles, so they read what they need from their
`device`; the mesh engine adds its shard count (`shards`, every visible
card by default), and the multi-process runner its rank and world size.

The engines live in backend/{bfs,batch,mesh,multihost,tiers}.py.  This module never
imports torch at import time — `python -m jaxmc_torch.obs` must keep
working anywhere.
"""

from __future__ import annotations

#: platform preference for "best live backend": higher wins (matches
#: obs/report.py's demotion rank — a backend swap downward is a REGRESS)
PLATFORM_RANK = {"cpu": 1, "gpu": 2, "tpu": 3}

#: the reference's selectable surface behind `--backend`: "interp" and
#: "jax" keep their historical meaning; the platform names pin the
#: device engine to one platform; "auto" asks the preflight oracle
BACKEND_CHOICES = ("interp", "jax", "auto", "cpu", "gpu", "tpu")
