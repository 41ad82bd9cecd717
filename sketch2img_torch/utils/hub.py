"""Hugging Face Hub download and publishing — counterpart of
``sketch2img_tpu/utils/hub.py``.

The anime2sketch generator's ``netG.pth`` comes from the hub, and the LGP
trainer pushes each epoch's export to a repository. Both need the network
and a token, so a failure (``huggingface_hub`` missing, no network, no
access) is printed and the caller goes on without the file or the push."""

from __future__ import annotations

import os
from typing import Optional

NETG_URL = "https://huggingface.co/datasets/nyanko7/tmp-public/resolve/main/netG.pth"


def download_netg(root: str = "./weights") -> Optional[str]:
    """``root/netG.pth``, fetched from the hub when absent; None when it
    cannot be fetched."""
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "netG.pth")
    if os.path.exists(path):
        return path
    try:
        from huggingface_hub import hf_hub_download

        return hf_hub_download(repo_id="nyanko7/tmp-public", filename="netG.pth",
                               repo_type="dataset", local_dir=root)
    except Exception as e:  # no hub library, no network, no access
        print(f"[hub] netG.pth download unavailable ({e}); provide --netg manually")
        return None


def push_file(repo_id: str, path: str, token: Optional[str] = None,
              commit_message: str = "update model") -> bool:
    """Upload ``path`` to ``repo_id`` under its base name. -> whether it
    was uploaded."""
    try:
        from huggingface_hub import HfApi

        HfApi().upload_file(path_or_fileobj=path, path_in_repo=os.path.basename(path),
                            repo_id=repo_id, token=token or None,
                            commit_message=commit_message)
        return True
    except Exception as e:
        print(f"[hub] publish to {repo_id} failed ({e})")
        return False
