from sonar_3d_reconstruction_tpu_torch.cli import main

raise SystemExit(main())
