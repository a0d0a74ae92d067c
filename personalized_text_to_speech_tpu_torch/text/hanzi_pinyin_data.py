"""Embedded hanzi → tone-numbered-pinyin table for the standalone fallback.

The reference gets full hanzi coverage from the ``pypinyin`` dependency
(reference ``text/mandarin.py:243-257``); this environment has no pypinyin,
so the live ZH G2P path needs its own data.  This module embeds a
several-thousand-character table (common simplified Chinese: GB2312
level-1 frequency range — everyday vocabulary, news vocabulary, names) plus
word-level overrides for frequent polyphonic characters.  It is DATA, not a
dependency: entries are ``<hanzi><pinyin><tone-digit>`` tokens, organized
alphabetically by syllable for review, parsed once at import.

Tone digits: 1-4 standard tones, 5 neutral.  ``v`` stands for ``ü``
(``nv3`` = nǚ), matching ``pinyin_syllable_to_bopomofo``'s conventions.
For polyphonic characters the single-character entry carries the most
common reading; ``WORD_PINYIN`` overrides whole jieba words where the
common reading differs in context (e.g. 银行 xing2→hang2).
"""

from __future__ import annotations

import re
from typing import Dict, List

# --- single-character readings, grouped by pinyin syllable ---------------
_ENTRIES = """
啊a1 阿a1 哎ai1 唉ai4 哀ai1 挨ai2 癌ai2 矮ai3 艾ai4 碍ai4 安an1 氨an1 俺an3
岸an4 按an4 案an4 暗an4 鞍an1 肮ang1 昂ang2 凹ao1 熬ao2 袄ao3 傲ao4 奥ao4
澳ao4 懊ao4
疤ba1 芭ba1 捌ba1 笆ba1 拔ba2 跋ba2 靶ba3 坝ba4 爸ba4 罢ba4 霸ba4 掰bai1
白bai2 柏bai3 摆bai3 败bai4 拜bai4 扳ban1 班ban1 般ban1 颁ban1 斑ban1 搬ban1
板ban3 版ban3 扮ban4 拌ban4 伴ban4 瓣ban4 邦bang1 帮bang1 绑bang3 榜bang3
膀bang3 棒bang4 磅bang4 镑bang4 傍bang4 谤bang4 包bao1 胞bao1 雹bao2 宝bao3
饱bao3 保bao3 堡bao3 报bao4 抱bao4 豹bao4 鲍bao4 暴bao4 爆bao4 卑bei1 杯bei1
悲bei1 碑bei1 贝bei4 备bei4 背bei4 倍bei4 被bei4 辈bei4 惫bei4 奔ben1 本ben3
笨ben4 崩beng1 绷beng1 蹦beng4 逼bi1 鼻bi2 彼bi3 笔bi3 鄙bi3 币bi4 必bi4
毕bi4 闭bi4 庇bi4 毙bi4 弊bi4 碧bi4 蔽bi4 壁bi4 避bi4 臂bi4 边bian1 编bian1
鞭bian1 贬bian3 扁bian3 便bian4 变bian4 遍bian4 辨bian4 辩bian4 辫bian4
标biao1 彪biao1 膘biao1 表biao3 鳖bie1 憋bie1 别bie2 彬bin1 宾bin1 滨bin1
冰bing1 兵bing1 丙bing3 柄bing3 饼bing3 并bing4 病bing4 拨bo1 波bo1 玻bo1
剥bo1 菠bo1 播bo1 博bo2 勃bo2 搏bo2 膊bo2 薄bo2 伯bo2 驳bo2 泊bo2 脖bo2
舶bo2 渤bo2 箔bo2 卜bu3 哺bu3 捕bu3 补bu3 埠bu4 怖bu4 部bu4 簿bu4
擦ca1 猜cai1 才cai2 材cai2 财cai2 裁cai2 采cai3 彩cai3 睬cai3 踩cai3 菜cai4
蔡cai4 参can1 餐can1 残can2 蚕can2 惭can2 惨can3 灿can4 仓cang1 苍cang1
舱cang1 藏cang2 操cao1 糙cao1 槽cao2 曹cao2 草cao3 册ce4 侧ce4 厕ce4 策ce4
层ceng2 曾ceng2 蹭ceng4 叉cha1 插cha1 茬cha2 茶cha2 查cha2 察cha2 岔cha4
差cha4 刹cha4 诧cha4 柴chai2 拆chai1 豺chai2 掺chan1 搀chan1 蝉chan2 馋chan2
缠chan2 铲chan3 阐chan3 颤chan4 昌chang1 猖chang1 尝chang2 偿chang2 肠chang2
厂chang3 场chang3 敞chang3 畅chang4 倡chang4 抄chao1 钞chao1 超chao1 巢chao2
朝chao2 潮chao2 吵chao3 炒chao3 车che1 扯che3 彻che4 撤che4 尘chen2 臣chen2
沉chen2 陈chen2 晨chen2 衬chen4 趁chen4 撑cheng1 承cheng2 诚cheng2 城cheng2
乘cheng2 惩cheng2 程cheng2 澄cheng2 橙cheng2 逞cheng3 秤cheng4 吃chi1
痴chi1 池chi2 驰chi2 迟chi2 持chi2 匙chi2 尺chi3 齿chi3 耻chi3 斥chi4
赤chi4 翅chi4 充chong1 冲chong1 虫chong2 崇chong2 宠chong3 抽chou1 仇chou2
绸chou2 愁chou2 稠chou2 筹chou2 酬chou2 丑chou3 臭chou4 初chu1 除chu2
厨chu2 锄chu2 雏chu2 橱chu2 楚chu3 础chu3 储chu3 处chu3 触chu4 畜chu4
川chuan1 穿chuan1 传chuan2 船chuan2 喘chuan3 串chuan4 疮chuang1 窗chuang1
床chuang2 闯chuang3 创chuang4 吹chui1 炊chui1 捶chui2 锤chui2 垂chui2
春chun1 纯chun2 唇chun2 蠢chun3 戳chuo1 绰chuo4 词ci2 瓷ci2 辞ci2 慈ci2
磁ci2 雌ci2 此ci3 次ci4 刺ci4 赐ci4 匆cong1 葱cong1 聪cong1 丛cong2 凑cou4
粗cu1 促cu4 醋cu4 簇cu4 窜cuan4 催cui1 脆cui4 翠cui4 村cun1 存cun2 寸cun4
搓cuo1 磋cuo1 撮cuo1 挫cuo4 措cuo4 错cuo4
搭da1 达da2 打da3 呆dai1 逮dai3 代dai4 带dai4 待dai4 怠dai4 袋dai4 贷dai4
戴dai4 丹dan1 单dan1 担dan1 耽dan1 胆dan3 旦dan4 淡dan4 蛋dan4 弹dan4
诞dan4 氮dan4 挡dang3 党dang3 荡dang4 档dang4 刀dao1 叨dao1 捣dao3 岛dao3
倒dao3 蹈dao3 悼dao4 盗dao4 稻dao4 德de2 灯deng1 登deng1 蹬deng1 等deng3
凳deng4 瞪deng4 邓deng4 堤di1 低di1 滴di1 迪di2 敌di2 笛di2 底di3 抵di3
帝di4 弟di4 递di4 颠dian1 典dian3 点dian3 电dian4 店dian4 垫dian4 殿dian4
淀dian4 惦dian4 奠dian4 叼diao1 雕diao1 吊diao4 钓diao4 调diao4 掉diao4
爹die1 跌die1 碟die2 蝶die2 叠die2 谍die2 丁ding1 叮ding1 盯ding1 钉ding1
顶ding3 鼎ding3 订ding4 定ding4 丢diu1 东dong1 冬dong1 董dong3 懂dong3
冻dong4 栋dong4 洞dong4 兜dou1 斗dou4 抖dou3 陡dou3 豆dou4 逗dou4 督du1
毒du2 读du2 独du2 堵du3 赌du3 杜du4 肚du4 度du4 渡du4 镀du4 端duan1
短duan3 段duan4 断duan4 缎duan4 锻duan4 堆dui1 兑dui4 吨dun1 蹲dun1 盾dun4
顿dun4 钝dun4 哆duo1 夺duo2 朵duo3 躲duo3 舵duo4 堕duo4 惰duo4 跺duo4
俄e2 鹅e2 蛾e2 额e2 恶e4 饿e4 鳄e4 恩en1 嗯en4
伐fa2 乏fa2 罚fa2 阀fa2 法fa3 帆fan1 番fan1 翻fan1 凡fan2 烦fan2 繁fan2
反fan3 返fan3 犯fan4 泛fan4 饭fan4 范fan4 贩fan4 方fang1 坊fang1 芳fang1
防fang2 妨fang2 房fang2 仿fang3 访fang3 纺fang3 放fang4 飞fei1 非fei1
啡fei1 肥fei2 匪fei3 诽fei3 肺fei4 废fei4 沸fei4 费fei4 吩fen1 纷fen1
芬fen1 氛fen1 坟fen2 焚fen2 粉fen3 奋fen4 愤fen4 粪fen4 份fen4 丰feng1
风feng1 枫feng1 封feng1 疯feng1 峰feng1 锋feng1 蜂feng1 逢feng2 缝feng2
讽feng3 凤feng4 奉feng4 佛fo2 否fou3 夫fu1 肤fu1 孵fu1 敷fu1 扶fu2 服fu2
俘fu2 浮fu2 符fu2 幅fu2 福fu2 辐fu2 抚fu3 斧fu3 俯fu3 辅fu3 腐fu3 父fu4
付fu4 妇fu4 附fu4 咐fu4 赴fu4 复fu4 副fu4 傅fu4 富fu4 腹fu4 覆fu4 缚fu4
该gai1 改gai3 盖gai4 溉gai4 概gai4 钙gai4 甘gan1 杆gan1 肝gan1 竿gan1
尴gan1 赶gan3 敢gan3 感gan3 干gan4 冈gang1 刚gang1 纲gang1 肛gang1 缸gang1
钢gang1 岗gang3 港gang3 杠gang4 篙gao1 皋gao1 高gao1 膏gao1 糕gao1 搞gao3
稿gao3 告gao4 哥ge1 胳ge1 鸽ge1 割ge1 搁ge1 格ge2 葛ge2 隔ge2 阁ge2 革ge2
个ge4 各ge4 给gei3 跟gen1 耕geng1 更geng4 埂geng3 耿geng3 工gong1 弓gong1
公gong1 功gong1 攻gong1 供gong1 宫gong1 恭gong1 躬gong1 巩gong3 汞gong3
共gong4 贡gong4 勾gou1 沟gou1 钩gou1 狗gou3 构gou4 购gou4 够gou4 估gu1
姑gu1 孤gu1 辜gu1 咕gu1 谷gu3 股gu3 骨gu3 鼓gu3 固gu4 故gu4 顾gu4 雇gu4
瓜gua1 刮gua1 寡gua3 挂gua4 褂gua4 乖guai1 拐guai3 怪guai4 关guan1 官guan1
冠guan1 棺guan1 馆guan3 贯guan4 惯guan4 灌guan4 罐guan4 光guang1 广guang3
逛guang4 归gui1 龟gui1 规gui1 硅gui1 轨gui3 鬼gui3 诡gui3 柜gui4 贵gui4
桂gui4 跪gui4 滚gun3 棍gun4 锅guo1 郭guo1 果guo3 裹guo3
"""

_ENTRIES_H_M = """
哈ha1 孩hai2 海hai3 骇hai4 害hai4 含han2 寒han2 韩han2 罕han3 喊han3
汗han4 旱han4 捍han4 悍han4 焊han4 憾han4 撼han4 夯hang1 航hang2 毫hao2
豪hao2 嚎hao2 好hao3 号hao4 浩hao4 耗hao4 呵he1 喝he1 禾he2 合he2 何he2
河he2 荷he2 核he2 盒he2 贺he4 赫he4 褐he4 鹤he4 黑hei1 嘿hei1 痕hen2
狠hen3 恨hen4 恒heng2 横heng2 衡heng2 哼heng1 轰hong1 烘hong1 虹hong2
洪hong2 宏hong2 鸿hong2 哄hong3 吼hou3 喉hou2 猴hou2 厚hou4 候hou4 呼hu1
忽hu1 胡hu2 壶hu2 湖hu2 糊hu2 蝴hu2 狐hu2 虎hu3 互hu4 户hu4 护hu4 沪hu4
花hua1 哗hua2 滑hua2 猾hua2 化hua4 划hua4 画hua4 话hua4 怀huai2 徊huai2
淮huai2 坏huai4 欢huan1 还huan2 环huan2 缓huan3 幻huan4 唤huan4 换huan4
患huan4 焕huan4 荒huang1 慌huang1 皇huang2 黄huang2 煌huang2 晃huang3
谎huang3 灰hui1 挥hui1 恢hui1 辉hui1 徽hui1 悔hui3 毁hui3 汇hui4 绘hui4
贿hui4 惠hui4 毁hui3 慧hui4 昏hun1 婚hun1 浑hun2 魂hun2 混hun4 活huo2
伙huo3 或huo4 货huo4 获huo4 祸huo4 惑huo4 霍huo4
讥ji1 击ji1 饥ji1 机ji1 肌ji1 鸡ji1 迹ji1 积ji1 基ji1 绩ji4 激ji1 及ji2
吉ji2 即ji2 急ji2 疾ji2 集ji2 籍ji2 辑ji2 嫉ji2 脊ji3 挤ji3 几ji3 技ji4
忌ji4 际ji4 季ji4 剂ji4 迹ji4 济ji4 既ji4 继ji4 寂ji4 寄ji4 纪ji4 记ji4
加jia1 夹jia1 佳jia1 枷jia1 嘉jia1 甲jia3 假jia3 价jia4 驾jia4 架jia4
嫁jia4 稼jia4 尖jian1 奸jian1 歼jian1 坚jian1 间jian1 肩jian1 艰jian1
监jian1 兼jian1 煎jian1 拣jian3 俭jian3 剪jian3 检jian3 减jian3 简jian3
碱jian3 见jian4 件jian4 建jian4 剑jian4 荐jian4 贱jian4 健jian4 舰jian4
渐jian4 践jian4 鉴jian4 键jian4 箭jian4 江jiang1 姜jiang1 将jiang1
僵jiang1 疆jiang1 奖jiang3 蒋jiang3 桨jiang3 匠jiang4 降jiang4 酱jiang4
交jiao1 郊jiao1 浇jiao1 娇jiao1 骄jiao1 胶jiao1 椒jiao1 焦jiao1 蕉jiao1
角jiao3 狡jiao3 饺jiao3 绞jiao3 脚jiao3 搅jiao3 缴jiao3 叫jiao4 轿jiao4
较jiao4 教jiao4 阶jie1 皆jie1 接jie1 秸jie1 街jie1 揭jie1 劫jie2 杰jie2
洁jie2 结jie2 捷jie2 截jie2 竭jie2 姐jie3 解jie3 介jie4 戒jie4 届jie4
界jie4 借jie4 巾jin1 今jin1 斤jin1 金jin1 津jin1 筋jin1 仅jin3 紧jin3
谨jin3 锦jin3 进jin4 晋jin4 浸jin4 禁jin4 劲jin4 茎jing1 京jing1 惊jing1
晶jing1 睛jing1 兢jing1 井jing3 颈jing3 景jing3 警jing3 净jing4 径jing4
竞jing4 竟jing4 敬jing4 境jing4 静jing4 镜jing4 纠jiu1 究jiu1 揪jiu1
酒jiu3 旧jiu4 救jiu4 舅jiu4 就jiu4 居ju1 拘ju1 鞠ju1 局ju2 菊ju2 橘ju2
咀ju3 举ju3 矩ju3 巨ju4 句ju4 拒ju4 具ju4 俱ju4 剧ju4 惧ju4 据ju4 距ju4
聚ju4 锯ju4 捐juan1 卷juan3 倦juan4 绢juan4 决jue2 诀jue2 绝jue2 掘jue2
爵jue2 军jun1 均jun1 君jun1 菌jun1 俊jun4 峻jun4 竣jun4 骏jun4
卡ka3 咖ka1 开kai1 凯kai3 慨kai3 刊kan1 勘kan1 砍kan3 坎kan3 康kang1
慷kang1 扛kang2 抗kang4 炕kang4 亢kang4 考kao3 烤kao3 拷kao3 靠kao4
科ke1 棵ke1 颗ke1 磕ke1 壳ke2 咳ke2 渴ke3 克ke4 刻ke4 客ke4 课ke4
肯ken3 恳ken3 啃ken3 坑keng1 空kong1 孔kong3 恐kong3 控kong4 口kou3
扣kou4 寇kou4 枯ku1 哭ku1 窟ku1 库ku4 裤ku4 酷ku4 夸kua1 垮kua3 跨kua4
挎kua4 块kuai4 快kuai4 筷kuai4 宽kuan1 款kuan3 筐kuang1 狂kuang2
况kuang4 旷kuang4 矿kuang4 框kuang4 亏kui1 葵kui2 魁kui2 馈kui4 愧kui4
昆kun1 捆kun3 困kun4 扩kuo4 括kuo4 阔kuo4 廓kuo4
垃la1 拉la1 啦la5 喇la3 腊la4 蜡la4 辣la4 莱lai2 赖lai4 兰lan2 拦lan2
栏lan2 蓝lan2 篮lan2 览lan3 懒lan3 烂lan4 滥lan4 郎lang2 狼lang2 廊lang2
朗lang3 浪lang4 捞lao1 劳lao2 牢lao2 姥lao3 涝lao4 烙lao4 勒le4 雷lei2
擂lei2 垒lei3 泪lei4 类lei4 累lei4 棱leng2 冷leng3 愣leng4 厘li2 狸li2
离li2 梨li2 犁li2 黎li2 篱li2 礼li3 李li3 理li3 鲤li3 力li4 历li4 厉li4
立li4 丽li4 利li4 励li4 例li4 隶li4 栗li4 粒li4 俐li4 痢li4 莉li4
俩lia3 帘lian2 怜lian2 莲lian2 联lian2 廉lian2 镰lian2 脸lian3 练lian4
炼lian4 恋lian4 链lian4 良liang2 凉liang2 梁liang2 粮liang2 粱liang2
亮liang4 谅liang4 晾liang4 量liang4 辆liang4 辽liao2 疗liao2 聊liao2
僚liao2 了liao3 料liao4 列lie4 劣lie4 烈lie4 猎lie4 裂lie4 邻lin2 林lin2
临lin2 淋lin2 琳lin2 磷lin2 鳞lin2 凛lin3 吝lin4 伶ling2 灵ling2 岭ling3
铃ling2 陵ling2 羚ling2 零ling2 龄ling2 领ling3 另ling4 溜liu1 刘liu2
流liu2 琉liu2 榴liu2 硫liu2 柳liu3 龙long2 笼long2 聋long2 隆long2
垄long3 楼lou2 搂lou3 漏lou4 陋lou4 卢lu2 芦lu2 炉lu2 鲁lu3 陆lu4 录lu4
鹿lu4 碌lu4 路lu4 驴lv2 旅lv3 屡lv3 缕lv3 铝lv3 履lv3 律lv4 虑lv4 率lv4
绿lv4 氯lv4 滤lv4 卵luan3 乱luan4 掠lve4 略lve4 抡lun1 轮lun2 伦lun2
沦lun2 论lun4 罗luo2 萝luo2 锣luo2 箩luo2 骡luo2 螺luo2 裸luo3 骆luo4
络luo4 洛luo4
妈ma1 麻ma2 马ma3 玛ma3 码ma3 蚂ma3 骂ma4 吗ma5 嘛ma5 埋mai2 买mai3
迈mai4 麦mai4 卖mai4 脉mai4 瞒man2 馒man2 蛮man2 满man3 漫man4 慢man4
蔓man4 忙mang2 芒mang2 盲mang2 茫mang2 莽mang3 猫mao1 毛mao2 矛mao2
茅mao2 茂mao4 冒mao4 贸mao4 帽mao4 貌mao4 枚mei2 玫mei2 眉mei2 梅mei2
媒mei2 煤mei2 霉mei2 每mei3 妹mei4 媚mei4 门men2 闷men4 萌meng2 蒙meng2
盟meng2 猛meng3 孟meng4 梦meng4 眯mi1 弥mi2 迷mi2 谜mi2 秘mi4 密mi4
蜜mi4 觅mi4 棉mian2 眠mian2 免mian3 勉mian3 娩mian3 缅mian3 庙miao4
描miao2 苗miao2 瞄miao2 秒miao3 渺miao3 妙miao4 灭mie4 蔑mie4 民min2
敏min3 闽min3 名ming2 明ming2 鸣ming2 铭ming2 命ming4 谬miu4 摸mo1
模mo2 膜mo2 摩mo2 磨mo2 蘑mo2 魔mo2 抹mo3 末mo4 沫mo4 茉mo4 陌mo4
莫mo4 漠mo4 墨mo4 默mo4 谋mou2 某mou3 牟mou2 母mu3 亩mu3 牡mu3 拇mu3
木mu4 目mu4 牧mu4 墓mu4 幕mu4 慕mu4 暮mu4 穆mu4
"""

_ENTRIES_N_S = """
拿na2 哪na3 纳na4 娜na4 钠na4 乃nai3 奶nai3 耐nai4 奈nai4 男nan2 南nan2
难nan2 囊nang2 挠nao2 恼nao3 脑nao3 闹nao4 呢ne5 内nei4 嫩nen4 能neng2
妮ni1 尼ni2 泥ni2 你ni3 拟ni3 逆ni4 腻ni4 溺ni4 年nian2 粘nian2 捻nian3
撵nian3 念nian4 娘niang2 酿niang4 鸟niao3 尿niao4 捏nie1 聂nie4 镊nie4
您nin2 宁ning2 凝ning2 柠ning2 拧ning3 牛niu2 扭niu3 纽niu3 钮niu3
农nong2 浓nong2 脓nong2 弄nong4 奴nu2 努nu3 怒nu4 女nv3 暖nuan3 挪nuo2
诺nuo4 懦nuo4 糯nuo4
哦o4 欧ou1 殴ou1 鸥ou1 偶ou3 呕ou3 藕ou3
趴pa1 爬pa2 怕pa4 帕pa4 拍pai1 排pai2 牌pai2 徘pai2 派pai4 攀pan1
盘pan2 判pan4 盼pan4 叛pan4 畔pan4 乓pang1 旁pang2 庞pang2 胖pang4
抛pao1 袍pao2 跑pao3 泡pao4 炮pao4 陪pei2 培pei2 赔pei2 佩pei4 配pei4
喷pen1 盆pen2 烹peng1 朋peng2 棚peng2 蓬peng2 膨peng2 鹏peng2 捧peng3
碰peng4 批pi1 披pi1 劈pi1 皮pi2 疲pi2 脾pi2 匹pi3 屁pi4 僻pi4 譬pi4
篇pian1 偏pian1 片pian4 骗pian4 漂piao1 飘piao1 瓢piao2 票piao4 撇pie3
拼pin1 贫pin2 频pin2 聘pin4 乒ping1 平ping2 评ping2 凭ping2 苹ping2
瓶ping2 萍ping2 坡po1 泼po1 颇po1 婆po2 迫po4 破po4 魄po4 剖pou1 扑pu1
铺pu1 仆pu2 菩pu2 葡pu2 蒲pu2 朴pu3 谱pu3 瀑pu4 曝pu4
欺qi1 戚qi1 期qi1 漆qi1 齐qi2 其qi2 奇qi2 歧qi2 祈qi2 骑qi2 棋qi2
旗qi2 乞qi3 企qi3 岂qi3 启qi3 起qi3 气qi4 弃qi4 汽qi4 契qi4 砌qi4
器qi4 恰qia4 洽qia4 千qian1 迁qian1 牵qian1 铅qian1 谦qian1 签qian1
前qian2 钱qian2 钳qian2 潜qian2 浅qian3 遣qian3 欠qian4 歉qian4 枪qiang1
腔qiang1 墙qiang2 蔷qiang2 抢qiang3 悄qiao1 敲qiao1 锹qiao1 乔qiao2
侨qiao2 桥qiao2 瞧qiao2 巧qiao3 翘qiao4 壳qiao4 俏qiao4 窍qiao4 切qie1
茄qie2 怯qie4 窃qie4 钦qin1 侵qin1 亲qin1 琴qin2 禽qin2 勤qin2 秦qin2
寝qin3 青qing1 轻qing1 倾qing1 清qing1 蜻qing1 晴qing2 顷qing3 请qing3
庆qing4 穷qiong2 琼qiong2 丘qiu1 秋qiu1 求qiu2 球qiu2 囚qiu2 区qu1
曲qu1 驱qu1 屈qu1 躯qu1 趋qu1 渠qu2 曲qu3 娶qu3 趣qu4 圈quan1 权quan2
全quan2 泉quan2 拳quan2 痊quan2 犬quan3 劝quan4 券quan4 缺que1 瘸que2
却que4 确que4 雀que4 鹊que4 裙qun2 群qun2
燃ran2 染ran3 嚷rang3 让rang4 饶rao2 扰rao3 绕rao4 惹re3 仁ren2 忍ren3
刃ren4 认ren4 任ren4 韧ren4 扔reng1 仍reng2 日ri4 荣rong2 绒rong2
溶rong2 熔rong2 融rong2 柔rou2 揉rou2 肉rou4 汝ru3 乳ru3 辱ru3 入ru4
软ruan3 锐rui4 瑞rui4 润run4 若ruo4 弱ruo4
撒sa1 洒sa3 萨sa4 塞sai1 赛sai4 三san1 叁san1 伞san3 散san4 桑sang1
嗓sang3 丧sang4 扫sao3 嫂sao3 骚sao1 色se4 涩se4 森sen1 僧seng1 杀sha1
沙sha1 纱sha1 刹sha1 砂sha1 傻sha3 厦sha4 筛shai1 晒shai4 山shan1
删shan1 衫shan1 珊shan1 闪shan3 陕shan3 扇shan4 善shan4 擅shan4 伤shang1
商shang1 赏shang3 晌shang3 尚shang4 裳shang5 捎shao1 烧shao1 梢shao1
稍shao1 勺shao2 少shao3 绍shao4 哨shao4 奢she1 舌she2 蛇she2 舍she3
设she4 社she4 射she4 涉she4 摄she4 申shen1 伸shen1 身shen1 深shen1
绅shen1 神shen2 沈shen3 审shen3 婶shen3 肾shen4 甚shen4 渗shen4 慎shen4
升sheng1 声sheng1 牲sheng1 胜sheng4 盛sheng4 剩sheng4 圣sheng4 绳sheng2
省sheng3 尸shi1 失shi1 师shi1 诗shi1 狮shi1 施shi1 湿shi1 十shi2 什shi2
拾shi2 食shi2 蚀shi2 实shi2 史shi3 使shi3 驶shi3 始shi3 屎shi3 士shi4
氏shi4 世shi4 仕shi4 势shi4 侍shi4 饰shi4 室shi4 恃shi4 拭shi4 柿shi4
是shi4 适shi4 逝shi4 释shi4 誓shi4 匙shi5 收shou1 熟shou2 守shou3
寿shou4 受shou4 狩shou4 授shou4 售shou4 兽shou4 瘦shou4 书shu1 叔shu1
殊shu1 梳shu1 舒shu1 疏shu1 输shu1 蔬shu1 赎shu2 暑shu3 鼠shu3 属shu3
薯shu3 数shu4 束shu4 树shu4 竖shu4 恕shu4 庶shu4 墅shu4 刷shua1 耍shua3
衰shuai1 摔shuai1 甩shuai3 帅shuai4 拴shuan1 霜shuang1 爽shuang3
水shui3 睡shui4 税shui4 顺shun4 瞬shun4 说shuo1 硕shuo4 丝si1 私si1
思si1 斯si1 撕si1 嘶si1 死si3 寺si4 饲si4 肆si4 松song1 宋song4
耸song3 颂song4 诵song4 搜sou1 艘sou1 嗽sou4 苏su1 酥su1 俗su2 诉su4
肃su4 素su4 宿su4 塑su4 酸suan1 蒜suan4 算suan4 虽sui1 隋sui2 遂sui2
碎sui4 岁sui4 穗sui4 隧sui4 孙sun1 损sun3 笋sun3 缩suo1 唆suo1 梭suo1
所suo3 索suo3 锁suo3
"""

_ENTRIES_T_Z = """
他ta1 它ta1 她ta1 塌ta1 塔ta3 踏ta4 胎tai1 台tai2 抬tai2 太tai4 态tai4
泰tai4 贪tan1 摊tan1 滩tan1 坛tan2 谈tan2 弹tan2 痰tan2 潭tan2 坦tan3
毯tan3 叹tan4 炭tan4 探tan4 碳tan4 汤tang1 唐tang2 堂tang2 塘tang2
膛tang2 糖tang2 躺tang3 倘tang3 烫tang4 趟tang4 涛tao1 掏tao1 滔tao1
逃tao2 桃tao2 陶tao2 萄tao2 淘tao2 讨tao3 套tao4 特te4 疼teng2 腾teng2
藤teng2 剔ti1 梯ti1 踢ti1 提ti2 题ti2 蹄ti2 体ti3 替ti4 剃ti4 涕ti4
天tian1 添tian1 田tian2 甜tian2 填tian2 舔tian3 挑tiao1 条tiao2 迢tiao2
调tiao2 跳tiao4 眺tiao4 贴tie1 铁tie3 帖tie3 厅ting1 听ting1 亭ting2
庭ting2 停ting2 蜓ting2 挺ting3 艇ting3 通tong1 同tong2 铜tong2 童tong2
桶tong3 捅tong3 统tong3 筒tong3 痛tong4 偷tou1 投tou2 透tou4 秃tu1
突tu1 图tu2 徒tu2 途tu2 涂tu2 屠tu2 土tu3 吐tu3 兔tu4 团tuan2 推tui1
腿tui3 退tui4 吞tun1 屯tun2 托tuo1 拖tuo1 脱tuo1 驼tuo2 妥tuo3 椭tuo3
拓tuo4 唾tuo4
挖wa1 蛙wa1 娃wa2 瓦wa3 袜wa4 歪wai1 外wai4 弯wan1 湾wan1 丸wan2 完wan2
玩wan2 顽wan2 挽wan3 晚wan3 碗wan3 宛wan3 婉wan3 万wan4 腕wan4 汪wang1
王wang2 亡wang2 网wang3 往wang3 枉wang3 妄wang4 忘wang4 旺wang4 望wang4
危wei1 威wei1 微wei1 巍wei1 为wei2 违wei2 围wei2 唯wei2 帷wei2 维wei2
伟wei3 伪wei3 尾wei3 纬wei3 委wei3 萎wei3 卫wei4 味wei4 畏wei4 胃wei4
喂wei4 慰wei4 魏wei4 温wen1 瘟wen1 文wen2 纹wen2 闻wen2 蚊wen2 稳wen3
吻wen3 紊wen3 问wen4 翁weng1 窝wo1 蜗wo1 卧wo4 握wo4 乌wu1 污wu1 呜wu1
屋wu1 巫wu1 诬wu1 吴wu2 吾wu2 午wu3 武wu3 伍wu3 侮wu3 舞wu3 捂wu3 勿wu4 务wu4
物wu4 误wu4 悟wu4 雾wu4 晤wu4
夕xi1 西xi1 吸xi1 昔xi1 析xi1 息xi1 牺xi1 悉xi1 惜xi1 晰xi1 稀xi1 溪xi1
锡xi1 熙xi1 膝xi1 嬉xi1 媳xi2 席xi2 袭xi2 洗xi3 喜xi3 戏xi4 系xi4 细xi4
隙xi4 虾xia1 瞎xia1 峡xia2 狭xia2 霞xia2 辖xia2 吓xia4 夏xia4 仙xian1
先xian1 纤xian1 掀xian1 鲜xian1 闲xian2 贤xian2 弦xian2 咸xian2 衔xian2
嫌xian2 显xian3 险xian3 鲜xian3 县xian4 限xian4 线xian4 宪xian4 陷xian4
馅xian4 羡xian4 献xian4 腺xian4 乡xiang1 相xiang1 香xiang1 厢xiang1
湘xiang1 箱xiang1 镶xiang1 详xiang2 祥xiang2 翔xiang2 享xiang3 响xiang3
饷xiang3 巷xiang4 项xiang4 象xiang4 像xiang4 橡xiang4 向xiang4 削xiao1
宵xiao1 消xiao1 萧xiao1 硝xiao1 销xiao1 潇xiao1 箫xiao1 嚣xiao1 淆xiao2
晓xiao3 校xiao4 孝xiao4 肖xiao4 笑xiao4 效xiao4 啸xiao4 些xie1 歇xie1 协xie2
邪xie2 胁xie2 挟xie2 斜xie2 携xie2 鞋xie2 写xie3 泄xie4 泻xie4 卸xie4
屑xie4 械xie4 蟹xie4 懈xie4 辛xin1 欣xin1 新xin1 薪xin1 信xin4 囟xin4
芯xin1 锌xin1 刑xing2 型xing2 醒xing3 杏xing4 姓xing4 幸xing4 性xing4
凶xiong1 兄xiong1 胸xiong1 雄xiong2 熊xiong2 休xiu1 修xiu1 羞xiu1
朽xiu3 秀xiu4 绣xiu4 袖xiu4 锈xiu4 嗅xiu4 须xu1 虚xu1 需xu1 徐xu2
许xu3 序xu4 叙xu4 畜xu4 绪xu4 续xu4 絮xu4 蓄xu4 宣xuan1 喧xuan1
玄xuan2 悬xuan2 旋xuan2 选xuan3 炫xuan4 绚xuan4 靴xue1 穴xue2 踪zong1
雪xue3 血xue4 勋xun1 熏xun1 寻xun2 巡xun2 旬xun2 询xun2 循xun2 训xun4
讯xun4 迅xun4 逊xun4 驯xun4
压ya1 呀ya1 押ya1 鸦ya1 鸭ya1 牙ya2 芽ya2 崖ya2 哑ya3 雅ya3 轧ya4
烟yan1 淹yan1 腌yan1 咽yan1 延yan2 严yan2 言yan2 岩yan2 炎yan2 沿yan2
研yan2 盐yan2 蜒yan2 颜yan2 掩yan3 眼yan3 衍yan3 厌yan4 宴yan4 艳yan4
验yan4 焰yan4 雁yan4 燕yan4 谚yan4 殃yang1 央yang1 秧yang1 扬yang2
羊yang2 阳yang2 杨yang2 洋yang2 仰yang3 养yang3 氧yang3 痒yang3 恙yang4
腰yao1 妖yao1 邀yao1 窑yao2 谣yao2 摇yao2 遥yao2 咬yao3 药yao4 耀yao4
爷ye2 椰ye1 噎ye1 野ye3 业ye4 叶ye4 页ye4 液ye4 腋ye4 伊yi1 衣yi1
医yi1 依yi1 仪yi2 夷yi2 宜yi2 姨yi2 移yi2 遗yi2 疑yi2 乙yi3 已yi3
蚁yi3 倚yi3 椅yi3 义yi4 亿yi4 忆yi4 艺yi4 议yi4 亦yi4 异yi4 役yi4
译yi4 易yi4 疫yi4 益yi4 谊yi4 逸yi4 翼yi4 翌yi4 因yin1 阴yin1 音yin1
姻yin1 吟yin2 银yin2 淫yin2 引yin3 饮yin3 隐yin3 瘾yin3 印yin4 应ying1
英ying1 婴ying1 樱ying1 鹰ying1 迎ying2 盈ying2 荧ying2 莹ying2 萤ying2
营ying2 蝇ying2 赢ying2 颖ying3 映ying4 硬ying4 拥yong1 庸yong1 永yong3
咏yong3 泳yong3 勇yong3 涌yong3 踊yong3 蛹yong3 优you1 忧you1 悠you1
幽you1 尤you2 由you2 邮you2 犹you2 油you2 游you2 铀you2 友you3 酉you3
幼you4 诱you4 迂yu1 淤yu1 余yu2 鱼yu2 娱yu2 渔yu2 愉yu2 愚yu2 榆yu2
舆yu2 宇yu3 羽yu3 语yu3 玉yu4 吁yu4 育yu4 郁yu4 狱yu4 浴yu4 预yu4
域yu4 欲yu4 御yu4 裕yu4 遇yu4 愈yu4 誉yu4 豫yu4 冤yuan1 鸳yuan1
渊yuan1 元yuan2 员yuan2 园yuan2 原yuan2 圆yuan2 援yuan2 缘yuan2 源yuan2
猿yuan2 辕yuan2 远yuan3 苑yuan4 怨yuan4 院yuan4 愿yuan4 曰yue1 约yue1
岳yue4 悦yue4 跃yue4 粤yue4 晕yun1 匀yun2 允yun3 孕yun4 运yun4 韵yun4
蕴yun4 酝yun4 熨yun4
砸za2 杂za2 灾zai1 栽zai1 宰zai3 载zai4 再zai4 咱zan2 攒zan3 暂zan4
赞zan4 脏zang1 葬zang4 遭zao1 糟zao1 凿zao2 早zao3 枣zao3 澡zao3 灶zao4
皂zao4 燥zao4 躁zao4 噪zao4 责ze2 择ze2 泽ze2 则ze2 贼zei2 怎zen3
增zeng1 赠zeng4 扎zha1 渣zha1 轧zha2 闸zha2 眨zha3 炸zha4 榨zha4 栅zha4
诈zha4 摘zhai1 宅zhai2 窄zhai3 债zhai4 寨zhai4 沾zhan1 粘zhan1 瞻zhan1
斩zhan3 展zhan3 崭zhan3 占zhan4 战zhan4 站zhan4 栈zhan4 绽zhan4 湛zhan4
张zhang1 章zhang1 彰zhang1 樟zhang1 涨zhang3 掌zhang3 丈zhang4 仗zhang4
杖zhang4 帐zhang4 账zhang4 胀zhang4 障zhang4 招zhao1 昭zhao1 找zhao3
沼zhao3 召zhao4 兆zhao4 罩zhao4 肇zhao4 遮zhe1 折zhe2 哲zhe2 辙zhe2
者zhe3 浙zhe4 蔗zhe4 贞zhen1 针zhen1 侦zhen1 珍zhen1 真zhen1 斟zhen1
诊zhen3 枕zhen3 阵zhen4 振zhen4 震zhen4 镇zhen4 争zheng1 征zheng1
挣zheng1 睁zheng1 蒸zheng1 郑zheng4 证zheng4 政zheng4 症zheng4 怔zheng4
帧zhen4 芝zhi1 枝zhi1 知zhi1 肢zhi1 织zhi1 脂zhi1 蜘zhi1 执zhi2 侄zhi2
直zhi2 值zhi2 职zhi2 植zhi2 殖zhi2 止zhi3 旨zhi3 址zhi3 纸zhi3 指zhi3
至zhi4 志zhi4 制zhi4 治zhi4 质zhi4 秩zhi4 致zhi4 智zhi4 滞zhi4 置zhi4
稚zhi4 掷zhi4 痔zhi4 窒zhi4 忠zhong1 终zhong1 钟zhong1 衷zhong1
肿zhong3 仲zhong4 众zhong4 重zhong4 州zhou1 舟zhou1 洲zhou1 粥zhou1
轴zhou2 肘zhou3 咒zhou4 宙zhou4 昼zhou4 皱zhou4 骤zhou4 珠zhu1 株zhu1
蛛zhu1 诸zhu1 猪zhu1 竹zhu2 烛zhu2 逐zhu2 主zhu3 煮zhu3 嘱zhu3 瞩zhu3
住zhu4 助zhu4 注zhu4 驻zhu4 柱zhu4 祝zhu4 著zhu4 筑zhu4 铸zhu4 抓zhua1
爪zhua3 专zhuan1 砖zhuan1 赚zhuan4 传zhuan4 撰zhuan4 桩zhuang1 庄zhuang1
妆zhuang1 壮zhuang4 状zhuang4 撞zhuang4 幢zhuang4 追zhui1 坠zhui4
缀zhui4 赘zhui4 准zhun3 准zhun3 捉zhuo1 桌zhuo1 卓zhuo2 灼zhuo2 浊zhuo2
酌zhuo2 啄zhuo2 着zhuo2 琢zhuo2 咨zi1 姿zi1 资zi1 滋zi1 仔zi3 籽zi3
紫zi3 字zi4 宗zong1 综zong1 棕zong1 总zong3 纵zong4 粽zong4 走zou3
奏zou4 揍zou4 租zu1 足zu2 族zu2 祖zu3 阻zu3 组zu3 诅zu3 钻zuan1 嘴zui3
罪zui4 醉zui4 尊zun1 遵zun1 昨zuo2 左zuo3 佐zuo3 做zuo4 坐zuo4 座zuo4
"""

# --- word-level overrides for frequent polyphones --------------------------
# jieba segments the sentence; whole-word matches here take precedence over
# per-character lookup (the role pypinyin's phrase dictionary plays in the
# reference path).  Values are space-separated tone-numbered syllables.
WORD_PINYIN: Dict[str, str] = {
    "银行": "yin2 hang2", "行业": "hang2 ye4", "行列": "hang2 lie4",
    "自行车": "zi4 xing2 che1", "发行": "fa1 xing2",
    "重要": "zhong4 yao4", "重新": "chong2 xin1", "重复": "chong2 fu4",
    "重庆": "chong2 qing4", "尊重": "zun1 zhong4", "严重": "yan2 zhong4",
    "长城": "chang2 cheng2", "长大": "zhang3 da4", "生长": "sheng1 zhang3",
    "增长": "zeng1 zhang3", "成长": "cheng2 zhang3", "校长": "xiao4 zhang3",
    "长江": "chang2 jiang1", "部长": "bu4 zhang3", "市长": "shi4 zhang3",
    "董事长": "dong3 shi4 zhang3",
    "音乐": "yin1 yue4", "乐器": "yue4 qi4", "乐曲": "yue4 qu3",
    "快乐": "kuai4 le4", "欢乐": "huan1 le4",
    "头发": "tou2 fa5", "理发": "li3 fa4", "发型": "fa4 xing2",
    "得到": "de2 dao4", "觉得": "jue2 de5", "记得": "ji4 de5",
    "值得": "zhi2 de5", "显得": "xian3 de5", "获得": "huo4 de2",
    "取得": "qu3 de2", "懂得": "dong3 de5", "舍得": "she3 de5",
    "睡觉": "shui4 jiao4", "午觉": "wu3 jiao4",
    "还是": "hai2 shi4", "还有": "hai2 you3", "还原": "huan2 yuan2",
    "归还": "gui1 huan2", "偿还": "chang2 huan2",
    "为了": "wei4 le5", "因为": "yin1 wei4", "为什么": "wei4 shen2 me5",
    "行为": "xing2 wei2", "认为": "ren4 wei2", "以为": "yi3 wei2",
    "成为": "cheng2 wei2", "作为": "zuo4 wei2",
    "地方": "di4 fang5", "地球": "di4 qiu2",
    "慢慢地": "man4 man4 de5", "好好地": "hao3 hao3 de5",
    "了解": "liao3 jie3", "了不起": "liao3 bu5 qi3",
    "着急": "zhao2 ji2", "着火": "zhao2 huo3", "着凉": "zhao2 liang2",
    "穿着": "chuan1 zhuo2", "沿着": "yan2 zhe5", "接着": "jie1 zhe5",
    "只有": "zhi3 you3", "只要": "zhi3 yao4", "只是": "zhi3 shi4",
    "一只": "yi4 zhi1", "船只": "chuan2 zhi1",
    "都市": "du1 shi4", "首都": "shou3 du1", "成都": "cheng2 du1",
    "干净": "gan1 jing4", "干燥": "gan1 zao4", "干涉": "gan1 she4",
    "饼干": "bing3 gan1", "干部": "gan4 bu4", "能干": "neng2 gan4",
    "干活": "gan4 huo2",
    "教书": "jiao1 shu1", "教给": "jiao1 gei3",
    "睡着": "shui4 zhao2", "找着": "zhao3 zhao2",
    "空气": "kong1 qi4", "天空": "tian1 kong1", "空间": "kong1 jian1",
    "空闲": "kong4 xian2", "空白": "kong4 bai2",
    "便宜": "pian2 yi5", "方便": "fang1 bian4",
    "调查": "diao4 cha2", "调动": "diao4 dong4", "调整": "tiao2 zheng3",
    "调节": "tiao2 jie2", "空调": "kong1 tiao2",
    "中间": "zhong1 jian1", "中奖": "zhong4 jiang3", "打中": "da3 zhong4",
    "种地": "zhong4 di4", "种植": "zhong4 zhi2", "种树": "zhong4 shu4",
    "好奇": "hao4 qi2", "爱好": "ai4 hao4", "好学": "hao4 xue2",
    "答应": "da1 ying4", "答案": "da2 an4", "回答": "hui2 da2",
    "应该": "ying1 gai1", "应当": "ying1 dang1", "应用": "ying4 yong4",
    "反应": "fan3 ying4", "适应": "shi4 ying4",
    "大夫": "dai4 fu5",
    "弹琴": "tan2 qin2", "弹钢琴": "tan2 gang1 qin2", "子弹": "zi3 dan4",
    "炸弹": "zha4 dan4",
    "暖和": "nuan3 huo5", "和面": "huo2 mian4", "附和": "fu4 he4",
    "差不多": "cha4 bu5 duo1", "出差": "chu1 chai1", "差别": "cha1 bie2",
    "差距": "cha1 ju4", "差异": "cha1 yi4",
    "假期": "jia4 qi1", "放假": "fang4 jia4", "请假": "qing3 jia4",
    "暑假": "shu3 jia4", "寒假": "han2 jia4",
    "血液": "xue4 ye4", "流血": "liu2 xue4",
    "倒是": "dao4 shi4", "倒车": "dao4 che1", "摔倒": "shuai1 dao3",
    "打倒": "da3 dao3",
    "数学": "shu4 xue2", "数字": "shu4 zi4", "数数": "shu3 shu4",
    "无数": "wu2 shu4",
    "背包": "bei1 bao1", "背负": "bei1 fu4",
    "处理": "chu3 li3", "处罚": "chu3 fa2", "相处": "xiang1 chu3",
    "到处": "dao4 chu4", "处长": "chu4 zhang3", "好处": "hao3 chu4",
    "坏处": "huai4 chu4",
    "旅行": "lv3 xing2", "行动": "xing2 dong4", "行人": "xing2 ren2",
    "举行": "ju3 xing2", "进行": "jin4 xing2", "流行": "liu2 xing2",
    "切磋": "qie1 cuo1", "一切": "yi2 qie4", "亲切": "qin1 qie4",
    "密切": "mi4 qie4",
    "相信": "xiang1 xin4", "相片": "xiang4 pian4", "照相": "zhao4 xiang4",
    "首相": "shou3 xiang4", "相声": "xiang4 sheng1",
    "几乎": "ji1 hu1", "茶几": "cha2 ji1",
    "似的": "shi4 de5", "相似": "xiang1 si4",
    "朝阳": "zhao1 yang2", "朝鲜": "chao2 xian3", "朝代": "chao2 dai4",
    "今朝": "jin1 zhao1",
    "传记": "zhuan4 ji4", "自传": "zi4 zhuan4", "传统": "chuan2 tong3",
    "宣传": "xuan1 chuan2", "传播": "chuan2 bo1",
    "系鞋带": "ji4 xie2 dai4", "关系": "guan1 xi5", "联系": "lian2 xi4",
    "奔头": "ben4 tou5", "投奔": "tou2 ben4",
    "省会": "sheng3 hui4", "反省": "fan3 xing3", "省悟": "xing3 wu4",
    "兴奋": "xing1 fen4", "兴趣": "xing4 qu4", "高兴": "gao1 xing4",
    "兴旺": "xing1 wang4", "复兴": "fu4 xing1",
    "薄荷": "bo4 he5", "单薄": "dan1 bo2", "薄弱": "bo2 ruo4",
    "剥削": "bo1 xue1", "削减": "xue1 jian3", "削弱": "xue1 ruo4",
    "降落": "jiang4 luo4", "投降": "tou2 xiang2", "降伏": "xiang2 fu2",
    "当天": "dang4 tian1", "当作": "dang4 zuo4", "上当": "shang4 dang4",
    "适当": "shi4 dang4", "恰当": "qia4 dang4",
    "奇怪": "qi2 guai4", "奇数": "ji1 shu4",
    "模样": "mu2 yang4", "模型": "mo2 xing2", "模范": "mo2 fan4",
    "宁可": "ning4 ke3", "宁愿": "ning4 yuan4", "安宁": "an1 ning2",
    "喝彩": "he4 cai3", "喝水": "he1 shui3",
    "更加": "geng4 jia1", "更换": "geng1 huan4", "更新": "geng1 xin1",
    "三更": "san1 geng1",
    "散步": "san4 bu4", "散布": "san4 bu4", "分散": "fen1 san4",
    "散文": "san3 wen2", "松散": "song1 san3",
    "曾经": "ceng2 jing1", "曾孙": "zeng1 sun1", "姓曾": "xing4 zeng1",
    "佛教": "fo2 jiao4", "仿佛": "fang3 fu2",
    "什么": "shen2 me5", "什锦": "shi2 jin3",
    "恶心": "e3 xin1", "可恶": "ke3 wu4", "厌恶": "yan4 wu4",
    "憎恶": "zeng1 wu4",
    "塞车": "sai1 che1", "要塞": "yao4 sai4", "堵塞": "du3 se4",
    "闭塞": "bi4 se4",
    "担子": "dan4 zi5", "扁担": "bian3 dan4", "担心": "dan1 xin1",
    "担任": "dan1 ren4",
    "吐血": "tu4 xue4", "呕吐": "ou3 tu4", "谈吐": "tan2 tu3",
    "号召": "hao4 zhao4", "呼号": "hu1 hao2", "号叫": "hao2 jiao4",
    "的确": "di2 que4", "目的": "mu4 di4", "打的": "da3 di1",
    "强迫": "qiang3 po4", "勉强": "mian3 qiang3", "倔强": "jue2 jiang4",
    "供给": "gong1 ji3", "提供": "ti2 gong1", "供应": "gong1 ying4",
    "口供": "kou3 gong4", "供奉": "gong4 feng4",
    "给予": "ji3 yu3", "给以": "gei3 yi3",
    "尽管": "jin3 guan3", "尽量": "jin3 liang4", "尽力": "jin4 li4",
    "尽头": "jin4 tou2",
    "累计": "lei3 ji4", "积累": "ji1 lei3", "劳累": "lao2 lei4",
    "连累": "lian2 lei3",
    "粘贴": "zhan1 tie1", "粘土": "nian2 tu3",
    "转弯": "zhuan3 wan1", "转变": "zhuan3 bian4", "旋转": "xuan2 zhuan4",
    "转动": "zhuan4 dong4",
    "石头": "shi2 tou5", "木头": "mu4 tou5", "舌头": "she2 tou5",
    "枕头": "zhen3 tou5", "馒头": "man2 tou5",
    "衣服": "yi1 fu5", "舒服": "shu1 fu5", "嘱咐": "zhu3 fu4",
    "玫瑰": "mei2 gui1", "蘑菇": "mo2 gu5", "葡萄": "pu2 tao5",
    "萝卜": "luo2 bo5", "豆腐": "dou4 fu5", "狐狸": "hu2 li5",
    "知识": "zhi1 shi5", "意思": "yi4 si5", "告诉": "gao4 su5",
    "事情": "shi4 qing5", "东西": "dong1 xi5", "明白": "ming2 bai5",
    "喜欢": "xi3 huan5", "朋友": "peng2 you5", "休息": "xiu1 xi5",
    "打扮": "da3 ban5", "打听": "da3 ting5", "咳嗽": "ke2 sou5",
    "商量": "shang1 liang5", "力量": "li4 liang4", "打量": "da3 liang5",
    "眼睛": "yan3 jing5", "耳朵": "er3 duo5", "鼻子": "bi2 zi5",
    "脑袋": "nao3 dai5", "月亮": "yue4 liang5", "时候": "shi2 hou5",
    "地道": "di4 dao5", "道地": "dao4 di4",
    "漂亮": "piao4 liang5", "漂流": "piao1 liu2", "漂白": "piao3 bai2",
    "结实": "jie1 shi5", "结果": "jie2 guo3", "结束": "jie2 shu4",
    # --- round-5 tranche: driven by the zh_goldens.tsv accuracy eval -----
    # reduplicated kinship terms (second syllable neutral; adverb
    # reduplications 人人/天天/常常 keep full tones via char defaults)
    "爸爸": "ba4 ba5", "妈妈": "ma1 ma5", "哥哥": "ge1 ge5",
    "姐姐": "jie3 jie5", "弟弟": "di4 di5", "妹妹": "mei4 mei5",
    "爷爷": "ye2 ye5", "奶奶": "nai3 nai5", "叔叔": "shu1 shu5",
    "舅舅": "jiu4 jiu5", "姑姑": "gu1 gu5", "伯伯": "bo2 bo5",
    "婆婆": "po2 po5", "太太": "tai4 tai5", "宝宝": "bao3 bao5",
    "娃娃": "wa2 wa5", "谢谢": "xie4 xie5", "星星": "xing1 xing5",
    # lexicalized neutral tones (现代汉语词典 citation forms)
    "先生": "xian1 sheng5", "学生": "xue2 sheng5", "认识": "ren4 shi5",
    "对不起": "dui4 bu5 qi3", "不好意思": "bu4 hao3 yi4 si5",
    "主意": "zhu3 yi5", "窗户": "chuang1 hu5", "聪明": "cong1 ming5",
    "名字": "ming2 zi5", "个子": "ge4 zi5", "尾巴": "wei3 ba5",
    "嘴巴": "zui3 ba5", "早上": "zao3 shang5", "晚上": "wan3 shang5",
    "清楚": "qing1 chu5", "多少": "duo1 shao5", "舒服": "shu1 fu5",
    "热闹": "re4 nao5", "客气": "ke4 qi5", "麻烦": "ma2 fan5",
    "厉害": "li4 hai5", "丈夫": "zhang4 fu5", "师傅": "shi1 fu5",
    "点心": "dian3 xin5", "豆腐": "dou4 fu5", "馄饨": "hun2 tun5",
    # 子-suffix nouns (neutral 子; semantic 子 words 电子/分子/原子/男子
    # keep zi3 via the char default)
    "桌子": "zhuo1 zi5", "椅子": "yi3 zi5", "孩子": "hai2 zi5",
    "房子": "fang2 zi5", "裤子": "ku4 zi5", "鞋子": "xie2 zi5",
    "帽子": "mao4 zi5", "袜子": "wa4 zi5", "筷子": "kuai4 zi5",
    "杯子": "bei1 zi5", "瓶子": "ping2 zi5", "盒子": "he2 zi5",
    "箱子": "xiang1 zi5", "日子": "ri4 zi5", "样子": "yang4 zi5",
    "肚子": "du4 zi5", "脑子": "nao3 zi5", "嗓子": "sang3 zi5",
    "鸭子": "ya1 zi5", "兔子": "tu4 zi5", "猴子": "hou2 zi5",
    "狮子": "shi1 zi5", "蚊子": "wen2 zi5", "虫子": "chong2 zi5",
    "橘子": "ju2 zi5", "桃子": "tao2 zi5", "饺子": "jiao3 zi5",
    "包子": "bao1 zi5", "本子": "ben3 zi5", "村子": "cun1 zi5",
    "院子": "yuan4 zi5", "被子": "bei4 zi5", "毯子": "tan3 zi5",
    "刀子": "dao1 zi5", "叉子": "cha1 zi5", "勺子": "shao2 zi5",
    "妻子": "qi1 zi5", "儿子": "er2 zi5", "孙子": "sun1 zi5",
    "小伙子": "xiao3 huo3 zi5", "影子": "ying3 zi5", "种子": "zhong3 zi5",
    # 头-suffix nouns (neutral 头)
    "木头": "mu4 tou5", "馒头": "man2 tou5", "舌头": "she2 tou5",
    "枕头": "zhen3 tou5", "拳头": "quan2 tou5", "骨头": "gu3 tou5",
    # 少 shào words (char default shao3)
    "少年": "shao4 nian2", "青少年": "qing1 shao4 nian2",
    "少女": "shao4 nü3", "少爷": "shao4 ye5",
    # 会 kuài / 还 huán words
    "会计": "kuai4 ji4", "会计师": "kuai4 ji4 shi1",
    "还给": "huan2 gei3", "还钱": "huan2 qian2", "还款": "huan2 kuan3",
    "还债": "huan2 zhai4", "退还": "tui4 huan2",
    # 空 kòng words (char default kong1)
    "有空": "you3 kong4", "没空": "mei2 kong4", "抽空": "chou1 kong4",
    "空儿": "kong4 er2",
    # 目的 dì (的 char default is the particle de5)
    "目的": "mu4 di4", "目的地": "mu4 di4 di4",
    # 得 dé words (standalone 得 now defaults to the complement particle
    # de5; 觉得/记得/值得-class neutral readings come from that default)
    "得以": "de2 yi3", "得出": "de2 chu1", "得知": "de2 zhi1",
    "得分": "de2 fen1", "得意": "de2 yi4", "得罪": "de2 zui4",
    "赢得": "ying2 de2", "夺得": "duo2 de2", "博得": "bo2 de2",
    "所得": "suo3 de2", "心得": "xin1 de2", "难得": "nan2 de2",
    "不得不": "bu4 de2 bu4", "非得": "fei1 dei3", "总得": "zong3 dei3",
    # 教 jiào words (standalone 教 now defaults to the verb jiāo)
    "教室": "jiao4 shi4", "教师": "jiao4 shi1", "教育": "jiao4 yu4",
    "教授": "jiao4 shou4", "教学": "jiao4 xue2", "教练": "jiao4 lian4",
    "教堂": "jiao4 tang2", "教材": "jiao4 cai2", "教科书": "jiao4 ke1 shu1",
    "宗教": "zong1 jiao4", "佛教": "fo2 jiao4", "道教": "dao4 jiao4",
    "基督教": "ji1 du1 jiao4", "请教": "qing3 jiao4", "教训": "jiao4 xun5",
    "教养": "jiao4 yang3", "教会": "jiao4 hui4", "指教": "zhi3 jiao4",
    "教程": "jiao4 cheng2", "教导": "jiao4 dao3", "任教": "ren4 jiao4",
    "助教": "zhu4 jiao4", "教条": "jiao4 tiao2", "教徒": "jiao4 tu2",
    "家教": "jia1 jiao4", "说教": "shuo1 jiao4", "管教": "guan3 jiao4",
}

# supplementary entries: frequency-ranked gaps found against the char set
# of jieba's most frequent words (names, literary, technical registers)
_ENTRIES_SUPP = """
二er4 右you4 支zhi1 予yu3 呈cheng2 谓wei4 朱zhu1 述shu4 廷ting2 阅yue4
卒zu2 耳er3 祭ji4 诏zhao4 姊zi3 啥sha2 堰yan4 赵zhao4 露lu4 杭hang2
圳zhen4 函han2 秉bing3 衙ya2 袁yuan2 埃ai1 蜀shu3 妃fei1 芙fu2 乾qian2
伏fu2 朕zhen4 禧xi3 陛bi4 靖jing4 矣yi3 敦dun1 赋fu4 吏li4 逻luo2
亥hai4 祀si4 藻zao3 瑶yao2 琦qi2 璃li2 贾jia3 坤kun1 旭xu4 匾bian3
瘤liu2 抑yi4 肴yao2 丫ya1 娥e2 羲xi1 阙que4 屿yu3 涯ya2 墩dun1
谐xie2 讼song4 珞luo4 丐gai4 瞅chou3 匈xiong1 辰chen2 冶ye3 枢shu1
喀ka1 浏liu2 檐yan2 禀bing3 擒qin2 庵an1 泌mi4 尬ga4 菱ling2 咋za3
畴chou2 帜zhi4 凰huang2 斋zhai1 哟yo5 钊zhao1 丞cheng2 绮qi3 陂bei1
淑shu1 甫fu3 肪fang2 岱dai4 砰peng1 厮si1 侯hou2 姆mu3 嗤chi1
谴qian3 酶mei2 缮shan4 釜fu3 讶ya4 缔di4 浆jiang1 圾ji1 娟juan1
衮gun3 赦she4 轩xuan1 逵kui2 叩kou4 陀tuo2 拽zhuai4 虏lu3 焖men4
捡jian3 扒ba1 卿qing1 耶ye1 涵han2 卦gua4 苯ben3 衢qu2 霖lin2
睿rui4 汰tai4 菲fei1 哇wa1 珂ke1 匕bi3 诰gao4 彭peng2 钧jun1 翊yi4
兀wu4 妾qie4 盏zhan3 戟ji3 魅mei4 锰meng3 惟wei2 粹cui4 堪kan1
姝shu1 鸪gu1 鹧zhe4 侠xia2 儒ru2 渝yu2 奕yi4 麓lu4 剌la4 鳌ao2
黔qian2 嫣yan1 娌li5 谕yu4 袱fu2 瑕xia2 吕lv3 佣yong1 醇chun2
暇xia2 裘qiu2 葫hu2 厥jue2 斡wo4 溃kui4 惕ti4 栖qi1 薇wei1 沐mu4
荫yin1 睹du3 钛tai4 煨wei1 甸dian4 禅chan2 拂fu2 鹃juan1 敕chi4
蓉rong2 嗣si4 镍nie4 谏jian4 剿jiao3 侗dong4 诛zhu1 蜿wan1 烩hui4
鲢lian2 腥xing1 祺qi2 敝bi4 啪pa1 焉yan1 咦yi2 汁zhi1 剁duo4 沃wo4
芷zhi3 噢o1 娑suo1 伽jia1 瑙nao3 裔yi4 讧hong4 姹cha4 窖jiao4
荤hun1 凌ling2 喃nan2 芋yu4 鲟xun2 豌wan1 徙xi3 糍ci2 崛jue2
辇nian3 弗fu2 卤lu3 揖yi1 翰han4 蓦mo4 逾yu2 鸠jiu1 拢long3
滇dian1 寞mo4 宦huan4 烁shuo4 嵋mei2 瑚hu2 彦yan4 膳shan4 耙pa2
呻shen1 漕cao2 迄qi4 钾jia3 咧lie3 嵩song1 诲hui4 娉ping1 隅yu2
邑yi4 馔zhuan4 蕃fan2 侥jiao3 寓yu4 鞘qiao4 畸ji1 涅nie4 桐tong2
冯feng2 殷yin1 溯su4 绾wan3 仑lun2 柬jian3 埔pu3 獾huan1 弼bi4
吆yao1 菇gu1 氓mang2 澹dan4 骼ge2 濮pu2 雍yong1 刨pao2 劾he2
羁ji1 洼wa1 溅jian4 邢xing2 檀tan2 芥jie4 伺si4 禹yu3 忒te4
崔cui1 趾zhi3 潼tong2 乍zha4 詹zhan1 诣yi4 萼e4 蜈wu2 蚣gong1
邵shao4 炯jiong3 咙long2 垣yuan2 殡bin4 煞sha4 镁mei3 禺yu2
斌bin1 枭xiao1 祠ci2 茨ci2 睦mu4 琛chen1 虞yu2 钴gu3 拈nian1
韦wei2 荆jing1 郡jun4 鄂e4 浜bang1 郧yun2 麋mi2 胪lu2 沔mian3
粑ba1 苕shao2 郢ying3 鞑da2 鳙yong1 予yu3 稷ji4 竖shu4 鲁lu3
僭jian4 祯zhen1 拱gong3 棣di4 璋zhang1 璇xuan2 珑long2 琊ya2
璀cui3 璨can4 琉liu2 琥hu3 珀po4 玮wei3 珺jun4 琨kun1 瑾jin3
璞pu2 瑛ying1 琪qi2 琳lin2 瑄xuan1 玥yue4 珈jia1 珅shan1
颐yi2 颔han4 颚e4 颅lu2 髓sui3 骸hai2 骷ku1 髅lou2 鬓bin4
魄po4 魇yan3 鬟huan2 鬃zong1 髦mao2 髻ji4 鬈quan2 鬣lie4
佑you4 俞yu2 傣dai3 厄e4 呐na4 呛qiang4 哉zai1 哩li5 唬hu3 啤pi2
嘻xi1 嚼jiao2 圭gui1 坪ping2 垸yuan4 壤rang3 夔kui2 婢bi4 婿xu4
宸chen2 寮liao2 导dao3 屏ping2 嵌qian4 幺yao1 府fu3 彝yi2 怡yi2
拚pan4 摧cui1 摹mo2 曼man4 杉shan1 柯ke1 楞leng2 榻ta4 槛kan3
氢qing1 淳chun2 皖wan3 睐lai4 瞰kan4 示shi4 署shu3 羹geng1 苇wei3
莎sha1 蒿hao1 蕲qi2 薛xue1 藉jie4 藩fan1 蠡li2 褰qian1 襄xiang1
襟jin1 赂lu4 赣gan4 蹇jian3 辟pi4 遏e4 饵er3 驸fu4 驿yi4 鸯yang1
涓juan1 剉cuo4 颊jia2 锥zhui1 镖biao1 铮zheng1 钥yao4 署shu3 薯shu3 蜀shu3
"""

# --- round-4 continuation tranche: top remaining gaps from a
# frequency-weighted sweep of the bundled jieba dictionary (~12k distinct
# hanzi, 100M weighted tokens; tools/eval_zh_coverage.py) — surnames,
# common literary/technical characters, and a few traditional forms -----
_ENTRIES_SUPP2 = """
绵mian2 浦pu3 戈ge1 尉wei4 姚yao2 蒂di4 瑜yu2 兹zi1 毅yi4 尹yin3 谭tan2
鳍qi2 喻yu4 禄lu4 潘pan1 樊fan2 炬ju4 募mu4 惶huang2 亨heng1 凸tu1 庐lu2
阮ruan3 璧bi4 冀ji4 椎zhui1 阎yan2 凄qi1 炳bing3 瑟se4 泣qi4 峨e2 胺an4
烯xi1 沧cang1 溢yi4 胚pei1 贮zhu4 恍huang3 桓huan2 敛lian3 狄di2 沽gu1
眷juan4 涡wo1 揽lan3 弘hong2 玲ling2 迭die2 郝hao3 粟su4 歹dai3 豚tun2
讳hui4 迦jia1 妓ji4 礁jiao1 嘲chao2 斐fei3 沛pei4 篷peng2 祁qi2 窦dou4
槐huai2 琐suo3 稽ji1 泵beng4 澜lan2 梗geng3 昧mei4 棘ji2 曙shu3 阜fu4
豁huo4 矢shi3 邹zou1 匣xia2 盔kui1 羌qiang1 缆lan3 抒shu1 芜wu2 汛xun4
酚fen1 苔tai2 冥ming2 窥kui1 矶ji1 晖hui1 倪ni2 瞥pie1 缉ji1 楠nan2
烷wan2 碾nian3 垦ken3 逍xiao1 佃dian4 梓zi3 驹ju1 嗡weng1 汹xiong1
沅yuan2 墟xu1 娴xian2 漳zhang1 孢bao1 濒bin1 峭qiao4 殉xun4 霎sha4
眶kuang4 靡mi3 矫jiao3 孽nie4 咚dong1 戎rong2 愕e4 啼ti2 笃du3 侣lv3
懿yi4 吭keng1 酯zhi3 氟fu2 邱qiu1 闺gui1 奎kui2 揣chuai3 茸rong2
棠tang2 怦peng1 晦hui4 瘫tan1 朔shuo4 渭wei4 蕾lei3 馨xin1 廖liao4
胥xu1 丕pi1 舜shun4 鲨sha1 苟gou3 裴pei2 麟lin2 叭ba1 漓li2 毗pi2
倭wo1 玺xi3 憎zeng1 楷kai3 柑gan1 妒du4 孜zi1 虐nve4 蒯kuai3 酰xian1
佬lao3 蚌bang4 沁qin4 侈chi3 噶ga2 锭ding4 胧long2 琅lang2 坞wu4
筵yan2 褶zhe3 觑qu4 酮tong2 篆zhuan4 醛quan2 唧ji1 绉zhou4 圻qi2 扼e4
毡zhan1 簧huang2 砥di3 撬qiao4 腮sai1 慑she4 朦meng2 冉ran3 胤yin4
攘rang3 牒die2 吱zhi1 嫔pin2 笙sheng1 碘dian3 霄xiao1 酋qiu2 灸jiu3
矗chu4 寥liao2 庚geng1 隘ai4 秭zi3 鲸jing1 苛ke1 梵fan4 垛duo4 臀tun2
颌he2 弩nu3 嘎ga1 俸feng4 纂zuan3 卯mao3 嗜shi4 札zha2 峙zhi4 姬ji1
戮lu4 瓮weng4 肋lei4 壕hao2 陇long3 蟾chan2 狈bei4 嘟du1 浚jun4
蛟jiao1 筝zheng1 铬ge4 惺xing1 兮xi1 蕊rui3 褚chu3 黛dai4 箍gu1
匡kuang1 椁guo3 梧wu2 惮dan4 胰yi2 擎qing2 绥sui2 拗niu4 弛chi2 匿ni4
蟠pan2 寅yin2 疹zhen3 尧yao2 悖bei4 桦hua4 黯an4 赃zang1 茵yin1
澧li3 後hou4 簡jian3 購gou4
瑰gui1 弧hu2 浣huan4 拙zhuo1 韬tao1 祷dao3 熄xi1 炖dun4 灞ba4
"""

# --- round-4 (cont.) supplement: simplified targets of the
# traditional→simplified fold (hanzi_trad_data.py) not previously
# covered, plus standalone additions from the coverage tail (壹 from
# the numeral pair 壹/貳, 腑 a real char among the mojibake) -----------
_ENTRIES_SUPP3 = """
壹yi1 贰er4 娄lou2 娅ya4 姗shan1 垭ya1 挚zhi4 怆chuang4 呗bei4 珏jue2
皑ai2 砚yan4 腑fu3
"""

_TOKEN = re.compile(r"([一-鿿])([a-z]+[1-5])")


def load_hanzi_pinyin() -> Dict[str, str]:
    """Parse the embedded entry blocks → {hanzi: 'pinyin+tone'}."""
    table: Dict[str, str] = {}
    for block in (_ENTRIES, _ENTRIES_H_M, _ENTRIES_N_S, _ENTRIES_T_Z,
                  _ENTRIES_SUPP, _ENTRIES_SUPP2, _ENTRIES_SUPP3):
        for ch, py in _TOKEN.findall(block):
            table.setdefault(ch, py)
    return table


def load_word_pinyin() -> Dict[str, List[str]]:
    """Word-level polyphone overrides → {word: [syllable, ...]}."""
    return {w: p.split() for w, p in WORD_PINYIN.items()}
