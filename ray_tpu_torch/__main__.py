from ray_tpu_torch.scripts.cli import main

main()
