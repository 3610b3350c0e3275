"""``python -m pixray_tpu_torch --drawer pixel --prompts sunrise --clip_models ViT-B/32 ...``"""

from pixray_tpu_torch import main

if __name__ == "__main__":
    main()
