from mit_driverless_cv_traininginfra.config.darknet_cfg import (  # noqa: F401
    NetConfig,
    VANILLA_ANCHORS,
    load_network_spec,
    parse_model_config,
    read_anchors_csv,
)
