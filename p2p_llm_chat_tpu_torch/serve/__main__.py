"""`python -m p2p_llm_chat_tpu_torch.serve` — start the Ollama-compatible
front of the PyTorch port.

Backend selected by SERVE_BACKEND (fake | torch), listen addr by
SERVE_ADDR, device by SERVE_DEVICE (default cuda). With
SERVE_ROUTER_UPSTREAMS set it starts the replica router over those URLs
instead (serve/router.py).
"""

from .api import main

main()
