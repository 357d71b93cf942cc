"""Every system the paper compares against (§7.2/§7.4), on the same
simulator substrate and latency model as uBFT:

  unreplicated — plain RPC to a single server (Fig 8 "Unrepl.")
  mu           — Mu [OSDI'20]: crash-tolerant SMR, leader RDMA-writes to
                 followers' memory without receiver CPU involvement
  minbft       — MinBFT [TC'13]: 2f+1 BFT SMR with an SGX trusted counter
                 (vanilla: clients use public-key crypto; hmac variant:
                 clients use enclave HMACs)
  sgx_counter  — SGX trusted-counter non-equivocation mechanism (Fig 10)
"""

from repro_torch.baselines.unreplicated import UnreplicatedServer, UnreplicatedClient, build_unreplicated
from repro_torch.baselines.mu import build_mu
from repro_torch.baselines.minbft import build_minbft

__all__ = ["UnreplicatedServer", "UnreplicatedClient", "build_unreplicated",
           "build_mu", "build_minbft"]
