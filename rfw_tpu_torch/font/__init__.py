from rfw_tpu_torch.font.plugin import FontPlugin, Section, Text
