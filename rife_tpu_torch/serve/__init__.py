"""The serving app (port of rife_tpu/serve): configuration, the video
standards analyzer, the service layer and the Gradio / HTTP frontends."""
