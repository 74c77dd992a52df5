"""Hyperparameter tables, as Python dicts.

The port's copy of
``nspeech_tpu/hparams/{audio,train,taco1,taco2,wavenet,simple_wavenet}.yaml``
(the configuration contract: same keys, same values). They are dicts and
not YAML because the port must run where no YAML parser is installed; a
test holds them equal to the JAX package's parsed files.
"""

AUDIO = {
    "cleaners": "english_cleaners",
    "num_mels": 80,
    "num_freq": 1025,
    "sample_rate": 20000,
    "frame_length_ms": 50,
    "frame_shift_ms": 12.5,
    "preemphasis": 0.97,
    "min_level_db": 100,
    "ref_level_db": 20,
    "max_iters": 300,
    # Decoder early stop: a step whose values are all within
    # +/-stop_threshold of zero ends the utterance (0.0 = exact zero).
    "stop_threshold": 0.0,
    "griffin_lim_iters": 60,
    "griffin_lim_momentum": 0.0,
    "power": 1.5,
    "silence_threshold": 0.1,
}

TRAIN = {
    "batch_size": 32,
    "batch_group_size": 8,
    "sample_size": 1,
    "queue_size": 32,
    "min_dequeue_ratio": 0.33,
    "adam": {"beta1": 0.9, "beta2": 0.999},
    "initial_learning_rate": 0.002,
    "learning_rate_decay_halflife": 100000,
    "decay_learning_rate": True,
    "use_cmudict": False,
    "ema_decay": 0.0,
    "scheduled_sampling_ratio": 0.0,
    "compute_dtype": "float32",
}

TACO1 = {
    "outputs_per_step": 5,
    "embedding_dim": 256,
    "speaker_embed_dim": 16,
    "num_speakers": 1,
    "attention_type": "bah",
    "drop_rate": 0.5,
    "encoder_prenet": [256, 128],
    "encoder_cbhg_banks": 16,
    "encoder_cbhg_bank_sizes": [128, 128],
    "attention_dim": 256,
    "decoder_dim": 256,
    "post_cbhg_banks": 8,
    "post_cbhg_bank_sizes": [256],
    "guided_attention_weight": 0.0,
    "guided_attention_sigma": 0.2,
    "attention_win_fwd": 0,
    "attention_win_back": 1,
}

TACO2 = {
    "outputs_per_step": 5,
    "embedding_dim": 256,
    "speaker_embed_dim": 16,
    "num_speakers": 1,
    "attention_type": "location_sensitive",
    "attention_dim": 256,
    "drop_rate": 0.5,
    "encoder_conv_layers": 3,
    "encoder_conv_width": 5,
    "encoder_conv_channels": 512,
    "encoder_lstm_units": 256,
    "attention_depth": 128,
    "decoder_lstm_units": 1024,
    "postnet_conv_layers": 5,
    "postnet_conv_width": 5,
    "postnet_conv_channels": 512,
    "expand_conv_layers": 5,
    "expand_conv_width": 5,
    "expand_conv_channels": 512,
    "expand_lstm_units": 256,
    "guided_attention_weight": 0.0,
    "guided_attention_sigma": 0.2,
    "attention_win_fwd": 0,
    "attention_win_back": 1,
}

WAVENET = {
    "outputs_per_step": 5,
    "filter_width": 2,
    "dilations_depth": 5,
    "dilations_length": 10,
    "residual_channels": 32,
    "dilation_channels": 32,
    "quantization_channels": 256,
    "skip_channels": 512,
    "use_biases": False,
    "scalar_input": False,
    "initial_filter_width": 32,
    "gc_channels": 0,
    "gc_category_cardinality": 0,
    "lc_channels": 0,
    "l2_regularization_strength": 0,
}

# The unconditioned vocoder preset: a preset of the one WaveNet class, as
# in the JAX package (lc_channels 0, so the sampler runs with M = 0).
SIMPLE_WAVENET = {
    "outputs_per_step": 5,
    "filter_width": 2,
    "dilations_depth": 5,
    "dilations_length": 10,
    "residual_channels": 32,
    "dilation_channels": 32,
    "quantization_channels": 256,
    "skip_channels": 512,
    "use_biases": False,
    "scalar_input": False,
    "initial_filter_width": 32,
    "gc_channels": 0,
    "gc_category_cardinality": 0,
    "lc_channels": 0,
    "l2_regularization_strength": 0,
}

MODELS = {"taco1": TACO1, "taco2": TACO2, "wavenet": WAVENET, "simple_wavenet": SIMPLE_WAVENET}
