from fastslam_tpu_torch.app.cli import main

raise SystemExit(main())
